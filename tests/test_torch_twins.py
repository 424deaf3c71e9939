"""The order-exact twins of the row-streaming CUDA kernels against the JAX
reference and the port's plain versions, on the same numpy inputs.

``tick_scatter_twin`` and ``clip_accumulate_twin`` repeat, in plain
torch, the add order of ``csrc/tick_fused.cu``'s ring sums and
``csrc/dp_clip.cu``'s norms and column sums (``kernels/row_tiles.py``:
blocks of consecutive rows, a tree over the block partials; the norm's
lane-strided sums and shuffle tree), so on the card the kernels are held
to them bit for bit (``tests/test_torch_cuda.py``).  Here, on the CPU,
each twin is held to the reference's Pallas kernel in interpret mode,
to the reference's plain version and to the port's ``ref.py`` within
``SUM_RTOL * sum|terms|`` (a reordered f32 sum), and bitwise where
nothing is reordered (w', U', an empty ring row, an all ``-0.0``
column).  Shapes: one row, a tile - 1, a tile, a tile + 1 and many
tiles (more than the partition's 264 blocks, so a block walks several
tiles); D of 1, 13 and 785; G of 1, 2, 8 and 32; all, none and half of
the rows done; ``dp_on`` off; bf16 for the clip.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dp_clip as jclip
from repro.kernels.tick_fused import ops as jops
from repro.kernels.tick_fused import ref as jref
from repro_torch.kernels import row_tiles
from repro_torch.kernels.dp_clip import (clip_accumulate_ref,
                                         clip_accumulate_twin)
from repro_torch.kernels.tick_fused import (tick_scatter_finish_twin,
                                            tick_scatter_ref,
                                            tick_scatter_rows_twin,
                                            tick_scatter_twin)

SUM_RTOL = 1e-5


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_partition_of_the_paths_shapes():
    """The blocks the paths' launches run: the main run's 16384 clients in
    256 blocks of 64 rows; the DP round's 60000 examples in 264 blocks of
    228 rows (f32) or 250 of 240 (bf16), its 6000-row microbatch in 250
    blocks of 24; one tile a block up to 264 tiles."""
    assert row_tiles.partition(16384, 4) == (64, 256)
    assert row_tiles.partition(60000, 12) == (228, 264)
    assert row_tiles.partition(60000, 24) == (240, 250)
    assert row_tiles.partition(6000, 12) == (24, 250)
    assert row_tiles.partition(264 * 4, 4) == (4, 264)
    assert row_tiles.partition(264 * 4 + 1, 4) == (8, 133)
    assert row_tiles.partition(0, 4)[1] == 0


@pytest.mark.parametrize("n", [1, 2, 5, 8, 9, 264])
def test_finish_tree_adds_every_partial_once_in_its_order(n):
    """Leaves of consecutive partials, ascending, combined pairwise: on
    integers (exact in f32) the tree is the plain sum, and its order is
    the one written out by hand for 5 leaves."""
    p = torch.arange(1, n + 1, dtype=torch.float32)[:, None]
    assert float(row_tiles.finish_tree(p)) == n * (n + 1) / 2
    if n == 5:
        x = torch.tensor([[1.0], [1e8], [-1e8], [3.0], [5.0]])
        want = ((x[0] + x[1]) + (x[2] + x[3])) + x[4]
        assert torch.equal(row_tiles.finish_tree(x), want)


def _scatter_inputs(C, D, G, share, seed):
    rng = np.random.default_rng(seed)
    sent, w, U = (rng.standard_normal((C, D)).astype(np.float32)
                  for _ in range(3))
    upd = rng.standard_normal((G, D)).astype(np.float32)
    sent[:, 0] = -0.0                  # an all -0.0 column ...
    upd[:, 0] = -0.0                   # ... onto -0.0 ring entries
    done = rng.random(C) < share if share not in (0.0, 1.0) else \
        np.full(C, share == 1.0)
    eta = (0.1 * rng.random(C)).astype(np.float32)
    pick = rng.integers(0, max(G - 1, 1), C)
    masks = np.stack([done & (pick == g) for g in range(G)])
    if G >= 2:
        masks[G - 1] = False           # a ring row nobody scatters into
    wgt = (eta[None, :] * masks).astype(np.float32)
    return sent, w, U, upd, wgt, masks.any(1), done, eta


@pytest.mark.parametrize("C,D,G,share,dp_on", [
    (1, 1, 1, 1.0, True),
    (3, 13, 2, 0.5, True),             # a tile - 1
    (4, 13, 2, 1.0, True),             # a tile, every row done
    (5, 13, 8, 0.0, True),             # a tile + 1, no row done
    (1100, 13, 8, 0.5, True),          # 275 tiles: two a block
    (37, 785, 32, 0.5, False),         # G past 8, dp off
    (70, 785, 2, 0.5, True),
])
def test_tick_scatter_twin_matches_reference(C, D, G, share, dp_on):
    args = _scatter_inputs(C, D, G, share, seed=C * 31 + G)
    sent, w, U, upd, wgt, any_g, done, eta = args
    got = [x.numpy() for x in tick_scatter_twin(
        *(torch.as_tensor(a) for a in args), dp_on=dp_on)]
    plain = [x.numpy() for x in tick_scatter_ref(
        *(torch.as_tensor(a) for a in args), dp_on=dp_on)]
    ja = [jnp.asarray(a) for a in args]
    j_ref = jref.tick_scatter_ref(*ja, dp_on=dp_on)
    j_ker = jops.tick_scatter(*ja, dp_on=dp_on, use_kernel=True,
                              interpret=True)
    absum = np.abs(wgt).astype(np.float64) @ np.abs(sent).astype(np.float64)
    tol = SUM_RTOL * absum + 1e-30
    for want in (plain[2], np.asarray(j_ref[2]), np.asarray(j_ker[2])):
        assert (np.abs(got[2] - want) <= tol).all()
    assert np.array_equal(_bits(got[0]), _bits(plain[0]))
    assert np.array_equal(_bits(got[1]), _bits(plain[1]))
    assert np.array_equal(_bits(got[1]), _bits(np.asarray(j_ref[1])))
    for g in range(G):
        if not any_g[g]:
            assert np.array_equal(_bits(got[2][g]), _bits(upd[g]))
    # the -0.0 column stays -0.0: no +0.0 start, no padded leaf
    assert np.signbit(got[2][:, 0]).all()


@pytest.mark.parametrize("C,D,G,P", [
    (20, 13, 2, 2),                    # 10 rows a rank, blocks of 4
    (20, 13, 8, 4),                    # 5 rows a rank
    (2, 7, 2, 2),                      # one block over both ranks
    (4, 7, 2, 4),                      # one block over four ranks
    (1160, 13, 3, 4),                  # blocks of 8, 290 rows a rank
    (1160, 5, 2, 2),
])
def test_rows_pass_cut_over_ranks_finishes_to_the_whole_twin(C, D, G, P):
    """tick_scatter's two passes as a cut client axis runs them: each
    rank's rows under the whole axis's rows per block, from their row
    offset, a block begun on an earlier rank continued from that rank's
    running sum (the carry); the complete blocks' partials, in block
    order, finished with the ring rows (and past them, rows of sums
    alone) are ``tick_scatter_twin``'s, bit for bit; w' and U' too."""
    sent, w, U, upd, wgt, any_g, done, eta = (
        torch.as_tensor(a) for a in _scatter_inputs(C, D, G, 0.5, seed=C))
    whole = tick_scatter_twin(sent, w, U, upd, wgt, any_g, done, eta,
                              dp_on=True)
    rb, nblk = row_tiles.partition(C, 4)
    n = C // P
    parts, carry, ws, us = [], None, [], []
    for r in range(P):
        lo, hi = r * n, (r + 1) * n
        w1, u1, p = tick_scatter_rows_twin(
            sent[lo:hi], w[lo:hi], U[lo:hi], wgt[:, lo:hi], done[lo:hi],
            eta[lo:hi], dp_on=True, rows_per_block=rb, row_offset=lo % rb,
            carry=carry if lo % rb else None)
        ws.append(w1)
        us.append(u1)
        carry = None
        if hi < C and hi % rb:       # its last block runs on past hi
            carry, p = p[-1], p[:-1]
        parts.append(p)
    partial = torch.cat(parts)
    assert partial.shape[0] == nblk
    out = tick_scatter_finish_twin(partial, upd, any_g)
    assert np.array_equal(_bits(out), _bits(whole[2]))
    assert np.array_equal(_bits(torch.cat(ws)), _bits(whole[0]))
    assert np.array_equal(_bits(torch.cat(us)), _bits(whole[1]))
    # rows past upd: the sums alone where any_g, 0.0 elsewhere (the far
    # tier's group sums ride the same passes)
    sums = tick_scatter_finish_twin(partial, None, any_g)
    on = tick_scatter_finish_twin(partial, upd[:1], None)
    total = row_tiles.finish_tree(partial)
    for g in range(G):
        want = total[g] if any_g[g] else torch.zeros(D)
        assert np.array_equal(_bits(sums[g]), _bits(want))
        if g:
            assert np.array_equal(_bits(on[g]), _bits(total[g]))


def test_rows_twin_carry_is_the_running_sum():
    """A block cut at any row: the second piece started from the first
    piece's partial gives the uncut block's partial bit for bit."""
    sent, w, U, _, wgt, _, done, eta = (
        torch.as_tensor(a) for a in _scatter_inputs(8, 13, 2, 1.0, seed=3))
    _, _, uncut = tick_scatter_rows_twin(sent, w, U, wgt, done, eta,
                                         dp_on=False, rows_per_block=8)
    for cut in range(1, 8):
        _, _, a = tick_scatter_rows_twin(
            sent[:cut], w[:cut], U[:cut], wgt[:, :cut], done[:cut],
            eta[:cut], dp_on=False, rows_per_block=8)
        _, _, b = tick_scatter_rows_twin(
            sent[cut:], w[cut:], U[cut:], wgt[:, cut:], done[cut:],
            eta[cut:], dp_on=False, rows_per_block=8, row_offset=cut,
            carry=a[0])
        assert b.shape[0] == 1
        assert np.array_equal(_bits(b[0]), _bits(uncut[0]))


def _clip_inputs(N, D, dtype, seed):
    g = (np.random.default_rng(seed).standard_normal((N, D)) * 3.0
         ).astype(np.float32)
    g[:, 0] = -0.0
    return g, torch.tensor(g).to(getattr(torch, dtype)), \
        jnp.asarray(g).astype(getattr(jnp, dtype))


def _np_terms(G, clip):
    """sum_n |G[n, d]| * min(1, clip / ||G[n]||) (numpy, f64)."""
    G = np.asarray(G, np.float64)
    s = 1.0 / np.maximum(1.0, np.linalg.norm(G, axis=1) / clip)
    return np.abs(G * s[:, None]).sum(0)


@pytest.mark.parametrize("N,D,dtype", [
    (1, 1, "float32"),
    (11, 13, "float32"),               # a tile - 1
    (12, 13, "float32"),               # a tile
    (13, 785, "float32"),              # a tile + 1
    (3300, 13, "float32"),             # 275 tiles: two a block
    (25, 785, "bfloat16"),             # a bf16 tile + 1
    (6600, 13, "bfloat16"),            # 275 bf16 tiles
])
def test_clip_accumulate_twin_matches_reference(N, D, dtype):
    _, tg, jg = _clip_inputs(N, D, dtype, seed=N + D)
    clip = 0.5
    got = clip_accumulate_twin(tg, clip).numpy()
    want_j = np.asarray(jclip.clip_accumulate(jg, clip=clip))
    plain = clip_accumulate_ref(tg, clip).numpy()
    tol = SUM_RTOL * _np_terms(np.asarray(jg.astype(jnp.float32)), clip)
    for want in (want_j, plain):
        assert (np.abs(got - want) <= tol + 1e-30).all()
    assert got.dtype == np.float32 and got.shape == (D,)
    assert np.signbit(got[0])


def test_clip_twin_norm_is_the_lane_strided_tree():
    """The twin's scale of one row, written out: lane sums over d = l,
    l + 32, ..., the xor tree's pairing, then 1 / max(1, norm / clip)."""
    x = torch.randn(1, 70)
    lanes = torch.zeros(32)
    for d in range(70):
        lanes[d % 32] = lanes[d % 32] + x[0, d] * x[0, d]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes[:off] + lanes[off:2 * off]
    scale = 1.0 / torch.clamp(torch.sqrt(lanes[:1]) / torch.tensor([0.3]),
                              min=1.0)
    from repro_torch.kernels.dp_clip.ref import row_scales
    assert torch.equal(row_scales(x, 0.3), scale)
