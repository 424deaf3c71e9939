"""The logistic-regression client block's plain twin
(``kernels/cohort_block/ref.py``), which the CPU runs and the card's
``cohort_logreg_block`` is held to bit for bit (tests/test_torch_cuda.py).

The oracle is the port's earlier client block, kept here: a loop of
``block`` steps over every client, each step's gradient multiplied by 0
past ``n[c]``.  The twin runs only the steps ``j < n[c]`` and sums its
two row sums in the kernel's lane order, so against the oracle it is
within rtol 1e-5 / atol 1e-6 (a few block steps of reordered f32 sums),
bit for bit on rows that take no step, and, with torch's own row sum put
back in place of the lane order and the CPU's division by the clip in
place of the card's (a product with the clip's f32 reciprocal, which
the twin takes on either device), equal but for the sign of exact zeros
(the oracle adds ``+-0`` where it masks a step).
"""
import numpy as np
import pytest
import torch

from repro_torch.cohort.tasks import CohortLogRegTask
from repro_torch.core import LogRegTask
from repro_torch.data import make_binary_dataset
from repro_torch.kernels import LAUNCHES, reset
from repro_torch.kernels.cohort_block import (lane_sum, logreg_block,
                                              logreg_block_ref)
from repro_torch.kernels.cohort_block import ref as block_ref
from repro_torch.kernels.cohort_block.kernel import (MAX_D,
                                                     logreg_block_kernel)
from repro_torch.models import logreg

RTOL, ATOL = 1e-5, 1e-6
# clips at which the reciprocal taken in double and the one taken in f32
# round to the same f32 (0.1, 1.0, 0.3, 3.7, 0.7) and apart (1e-3,
# 2e-3, 0.03, 0.013)
CLIPS = [0.1, 1.0, 0.3, 3.7, 0.7, 1e-3, 2e-3, 0.03, 0.013]


def masked_loop(ct, w, U, n, eta, block, idx):
    """The client block as the port ran it before the kernel: ``block``
    steps for every client, masked by ``j < n[c]``."""
    d = ct.d_feat
    l2, clip = ct.task.l2, ct.task.dp_clip
    pw, pb = w[:, :d], w[:, d]
    uw, ub = U[:, :d], U[:, d]
    eta_w = eta[:, None]
    for j in range(block):
        ij = idx[:, j]
        gw, gb = logreg.per_example_grad(pw, pb, ct.X[ij], ct.y[ij], l2)
        if clip > 0.0:
            norm = torch.sqrt(gb * gb + (gw * gw).sum(dim=-1))
            scale = 1.0 / torch.clamp(norm / clip, min=1.0)
            gw, gb = gw * scale[..., None], gb * scale
        act = (j < n).to(torch.float32)
        gw = act[:, None] * gw
        gb = act * gb
        uw = uw + gw
        ub = ub + gb
        pw = pw - eta_w * gw
        pb = pb - eta * gb
    return (torch.cat([pw, pb[:, None]], dim=1),
            torch.cat([uw, ub[:, None]], dim=1))


def _case(d, clip, l2, n_kind, C=48, block=16, seed=0):
    X, y = make_binary_dataset(400, d, seed=9, noise=0.3)
    ct = CohortLogRegTask(LogRegTask(X, y, l2=l2, dp_clip=clip,
                                     sample_seed=3), C, device="cpu")
    g = torch.Generator().manual_seed(seed)
    w = 0.1 * torch.randn(C, d + 1, generator=g)
    U = 0.1 * torch.randn(C, d + 1, generator=g)
    i = torch.randint(0, 5, (C,), generator=g, dtype=torch.int32)
    h = torch.randint(0, 20, (C,), generator=g, dtype=torch.int32)
    if n_kind == "ragged":
        n = torch.randint(0, block + 1, (C,), generator=g, dtype=torch.int32)
        n[:3] = torch.tensor([0, 1, block], dtype=torch.int32)
    elif n_kind == "zero":
        n = torch.zeros(C, dtype=torch.int32)
    else:
        n = torch.full((C,), block, dtype=torch.int32)
    eta = 0.1 * torch.rand(C, generator=g)
    return ct, w, U, i, h, n, eta, block, ct.sample_idx(i, h, block)


CASES = [(784, 0.1, 1.0 / 60000), (24, 0.0, 0.0), (33, 0.1, 0.0),
         (12, 0.0, 0.01), (3, 0.1, 0.1)]


@pytest.mark.parametrize("d,clip,l2", CASES)
@pytest.mark.parametrize("n_kind", ["ragged", "full", "zero"])
def test_twin_matches_the_masked_loop(d, clip, l2, n_kind):
    ct, w, U, i, h, n, eta, block, idx = _case(d, clip, l2, n_kind)
    got = ct.run_block(w, U, i, h, n, eta, block)
    want = masked_loop(ct, w, U, n, eta, block, idx)
    for a, b, old in zip(got, want, (w, U)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)
        idle = n == 0          # no step: the rows' bits come back
        assert torch.equal(a[idle].view(torch.int32),
                           old[idle].view(torch.int32))


@pytest.mark.parametrize("d,clip,l2", CASES)
def test_twin_is_the_masked_loop_but_for_the_sums_order(monkeypatch, d,
                                                         clip, l2):
    """With torch's row sum in place of the lane order and the CPU's
    division by the clip in place of the card's product with its
    reciprocal, the twin and the masked loop compute the same numbers (a
    masked step's ``+-0`` can only flip the sign of an exact zero)."""
    ct, w, U, i, h, n, eta, block, idx = _case(d, clip, l2, "ragged")
    monkeypatch.setattr(block_ref, "lane_sum", lambda v: v.sum(dim=-1))
    monkeypatch.setattr(block_ref, "clip_scale", lambda norm, clip: 1.0 / (
        torch.clamp(norm / clip, min=1.0)))
    got = ct.run_block(w, U, i, h, n, eta, block)
    want = masked_loop(ct, w, U, n, eta, block, idx)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _lane_order(v):
    """The kernel's two row sums, lane by lane in numpy float32: lane l
    adds groups of four l, l + 32, ... into four accumulators from +0.0
    and tail element 4 (m // 4) + l into the first; then
    ((a0 + a1) + a2) + a3, then a shuffle-down tree into lane 0."""
    out = []
    for row in np.asarray(v, np.float32):
        m = len(row)
        q, t = divmod(m, 4)
        acc = np.zeros((32, 4), np.float32)
        for g in range(q):
            for i in range(4):
                acc[g % 32, i] = np.float32(acc[g % 32, i] + row[4 * g + i])
        for ln in range(t):
            acc[ln, 0] = np.float32(acc[ln, 0] + row[4 * q + ln])
        lanes = [np.float32(np.float32(np.float32(a[0] + a[1]) + a[2]) + a[3])
                 for a in acc]
        for off in (16, 8, 4, 2, 1):
            lanes = [np.float32(lanes[ln] + lanes[ln + off]) if ln + off < 32
                     else lanes[ln] for ln in range(32)]
        out.append(lanes[0])
    return np.array(out, np.float32)


@pytest.mark.parametrize("m", [1, 5, 31, 32, 33, 100, 130, 784, 785, 899])
def test_lane_sum_is_the_kernels_order(m):
    rng = np.random.default_rng(m)
    v = (rng.normal(size=(6, m)) * 10.0 ** rng.integers(-3, 4, (6, m))
         ).astype(np.float32)
    v[0] = -0.0                    # a sum from +0.0 of -0.0 reads +0.0
    v[1, ::2] = 0.0
    got = lane_sum(torch.as_tensor(v)).numpy()
    assert np.array_equal(got.view(np.int32), _lane_order(v).view(np.int32))
    assert not np.signbit(got[0])


def test_cpu_block_runs_the_twin_and_launches_nothing():
    ct, w, U, i, h, n, eta, block, idx = _case(24, 0.1, 0.01, "ragged")
    reset()
    ct.spans = type("Rec", (), {"launches": []})()
    got = ct.run_block(w, U, i, h, n, eta, block)
    want = logreg_block_ref(w, U, idx, n, eta, ct.X, ct.y, l2=ct.task.l2,
                            clip=ct.task.dp_clip)
    direct = logreg_block(w, U, idx, n, eta, ct.X, ct.y, l2=ct.task.l2,
                          clip=ct.task.dp_clip)
    for a, b, c in zip(got, want, direct):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    assert LAUNCHES["cohort_logreg_block"] == 0
    assert ct.spans.launches == []          # no launch, nothing recorded


def test_rank_view_takes_its_rows_of_the_whole_block():
    """``for_clients`` (a rank's rows of the clients axis): its block is
    the whole population's block on those rows, bit for bit."""
    ct, w, U, i, h, n, eta, block, _ = _case(33, 0.1, 0.0, "ragged")
    lo, hi = 7, 30
    whole = ct.run_block(w, U, i, h, n, eta, block)
    part = ct.for_clients(lo, hi).run_block(
        w[lo:hi], U[lo:hi], i[lo:hi], h[lo:hi], n[lo:hi], eta[lo:hi], block)
    for a, b in zip(whole, part):
        assert torch.equal(a[lo:hi].view(torch.int32), b.view(torch.int32))


def test_more_features_than_the_kernel_holds_raise():
    """The kernel's rows hold at most MAX_D features; past that the
    launcher refuses before it builds or launches anything."""
    C, D = 4, MAX_D + 2
    w = torch.zeros(C, D)
    with pytest.raises(ValueError, match=f"at most {MAX_D} features"):
        logreg_block_kernel(w, w, torch.zeros(C, 2, dtype=torch.int64),
                            torch.ones(C, dtype=torch.int32), torch.ones(C),
                            torch.zeros(5, D - 1), torch.zeros(5), l2=0.0,
                            clip=0.0)


@pytest.mark.parametrize("clip", CLIPS)
def test_clip_scale_multiplies_by_the_clips_f32_reciprocal(clip):
    """The twin's clip step: ``norm * f32(1 / clip)`` on the CPU too, so
    both devices give the card's bits (the card test holds the card's
    ``norm / clip`` to the same product)."""
    norm = torch.rand(4096, generator=torch.Generator().manual_seed(7)) * 3
    inv = np.float32(1.0 / clip)
    want = 1.0 / np.maximum(norm.numpy() * inv, np.float32(1.0))
    got = block_ref.clip_scale(norm, clip)
    assert np.array_equal(got.numpy().view(np.int32),
                          want.astype(np.float32).view(np.int32))
    assert block_ref.inv_clip(0.0) == 0.0
    if clip in (1e-3, 2e-3, 0.03, 0.013):
        assert inv != np.float32(1.0) / np.float32(clip)
