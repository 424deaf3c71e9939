"""The port's plain kernel versions against the JAX reference's ``ref.py``
and its Pallas kernels in interpret mode, on the same numpy inputs.

bucket_apply and tick_deliver only select values and round one product
and one difference per element, so they are bitwise against the eager
``ref.py``; tick_scatter's w and U outputs too.  Under ``jit`` (the
interpret-mode kernels) XLA's CPU backend contracts ``a - b * c`` into
one fused multiply-add, which the port's eager plain versions (and its
CUDA kernels, built without contraction) do not: there the gap is one
rounding of the product, held to FMA_RTOL * (|b * c| + |result|).
tick_scatter's ring rows and cohort_clip_noise's row norms and weighted
sum reduce over clients, and torch.sum adds in another order than XLA:
those are held to SUM_RTOL * sum|terms| (the error of a reordered f32
sum is a small multiple of eps * sum|terms|).
On CPU tensors the port's wrappers run exactly these plain versions and
count no kernel launch.

The in-kernel-noise version (``cohort_clip_noise_prng``) has no JAX
counterpart off the TPU (the reference's kernel reseeds the TPU's own
PRNG per tile): its plain version is held to its own contract — the
counter stream is jax's threefry on the flat index, the normals pass the
reference's distribution test (tests/test_tick_fused.py), keys of
adjacent ticks are uncorrelated, and everything but the noise is the
operand version's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cohort_dp.kernel import cohort_clip_noise_kernel
from repro.kernels.cohort_dp.ref import cohort_clip_noise_ref as j_clip_ref
from repro.kernels.tick_fused import ops as jops
from repro.kernels.tick_fused import ref as jref
from repro_torch import prng
from repro_torch.analysis.salts import NOISE_SALT
from repro_torch.kernels import LAUNCHES, reset
from repro_torch.kernels.cohort_dp import (cohort_clip_noise,
                                           cohort_clip_noise_prng,
                                           cohort_clip_noise_prng_ref,
                                           cohort_clip_noise_ref,
                                           counter_normals)
from repro_torch.kernels.tick_fused import (bucket_apply, bucket_apply_ref,
                                            tick_deliver, tick_deliver_ref,
                                            tick_scatter, tick_scatter_ref)
from repro_torch.kernels.tick_fused.ops import on_cuda

SUM_RTOL = 1e-5
FMA_RTOL = 2.0 ** -23


def _t(a):
    return torch.as_tensor(np.array(a))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _assert_bitwise(a, b):
    assert np.array_equal(_bits(a), _bits(b))


def _jax_variants(fn_ref, fn_ops, *args, **kw):
    """(eager jax ref output, jitted interpret-mode kernel output)."""
    args = [jnp.asarray(a) for a in args]
    ref = fn_ref(*args, **kw)
    ker = fn_ops(*args, use_kernel=True, interpret=True, **kw)
    return ref, ker


def _assert_fma_close(fused, plain, prod):
    """``fused`` rounds ``x - prod`` once, ``plain`` rounds prod first."""
    fused, plain = np.asarray(fused), np.asarray(plain)
    tol = FMA_RTOL * (np.abs(prod) + np.abs(plain))
    assert (np.abs(fused - plain) <= tol).all()


@pytest.mark.parametrize("A", [1, 3])
@pytest.mark.parametrize("flag", [True, False])
def test_bucket_apply_plain_matches_reference(A, flag):
    rng = np.random.default_rng(A)
    D = 37
    v = rng.normal(size=D).astype(np.float32)
    rows = rng.normal(size=(A, D)).astype(np.float32)
    dec = (rng.random(A) + 0.5).astype(np.float32) if A > 1 else \
        np.ones(1, np.float32)
    # a -0.0 row against a -0.0 server vector: scale-not-sum keeps the
    # sign (0.0 + -0.0 would flip it and give -0.0 instead of +0.0)
    v[:5] = -0.0
    rows[0, :5] = -0.0
    got = bucket_apply_ref(_t(v), _t(rows), _t(dec), torch.tensor(flag))
    for want in _jax_variants(jref.bucket_apply_ref, jops.bucket_apply,
                              v, rows, dec, np.bool_(flag)):
        if A == 1:
            _assert_bitwise(want, got.numpy())
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
    if A == 1 and flag:
        assert not np.signbit(got.numpy()[:5]).any()


def test_tick_deliver_plain_matches_reference():
    rng = np.random.default_rng(1)
    C, D, B = 19, 37, 4
    w = rng.normal(size=(C, D)).astype(np.float32)
    U = rng.normal(size=(C, D)).astype(np.float32)
    bc_v = rng.normal(size=(B, D)).astype(np.float32)
    best = rng.integers(0, B, C).astype(np.int32)
    take = rng.random(C) < 0.6           # pass-through rows keep w
    eta = (0.1 * rng.random(C)).astype(np.float32)
    got = tick_deliver_ref(_t(w), _t(U), _t(bc_v), _t(best).long(),
                           _t(take), _t(eta)).numpy()
    ref, ker = _jax_variants(jref.tick_deliver_ref, jops.tick_deliver,
                             w, U, bc_v, best, take, eta)
    _assert_bitwise(ref, got)
    _assert_fma_close(ker, got, eta[:, None] * U)
    _assert_bitwise(got[~take], w[~take])


@pytest.mark.parametrize("dp_on", [True, False])
def test_tick_scatter_plain_matches_reference(dp_on):
    rng = np.random.default_rng(2)
    C, D, G = 21, 37, 3
    sent = rng.normal(size=(C, D)).astype(np.float32)
    w = rng.normal(size=(C, D)).astype(np.float32)
    U = rng.normal(size=(C, D)).astype(np.float32)
    upd = rng.normal(size=(G, D)).astype(np.float32)
    done = rng.random(C) < 0.5
    eta = (0.1 * rng.random(C)).astype(np.float32)
    slot = rng.integers(0, 2, C)
    # ring row 2 receives nobody: the guarded add leaves it bitwise
    masks = [done & (slot == 0), done & (slot == 1), np.zeros(C, bool)]
    wgt = np.stack([eta * m.astype(np.float32) for m in masks])
    any_g = np.array([m.any() for m in masks])
    got = tick_scatter_ref(_t(sent), _t(w), _t(U), _t(upd), _t(wgt),
                           _t(any_g), _t(done), _t(eta), dp_on=dp_on)
    got = [g.numpy() for g in got]
    absum = np.abs(wgt) @ np.abs(sent)
    ref, ker = _jax_variants(jref.tick_scatter_ref, jops.tick_scatter,
                             sent, w, U, upd, wgt, any_g, done, eta,
                             dp_on=dp_on)
    for want, fused in ((ref, False), (ker, True)):
        w_j, u_j, upd_j = (np.asarray(x) for x in want)
        if fused:
            _assert_fma_close(w_j, got[0], eta[:, None] * (sent - U))
        else:
            _assert_bitwise(w_j, got[0])
        _assert_bitwise(u_j, got[1])
        assert (np.abs(upd_j - got[2]) <= SUM_RTOL * absum + 1e-30).all()
    _assert_bitwise(got[2][2], upd[2])
    _assert_bitwise(got[1][~done], sent[~done])


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("noise_scale", [0.8, 0.0])
def test_cohort_clip_noise_plain_matches_reference(clip, noise_scale):
    rng = np.random.default_rng(3)
    C, D = 16, 64                 # the Pallas kernel's C % 8, D % 64 tiling
    u = (0.2 * rng.normal(size=(C, D))
         * (2.0 * rng.random(C))[:, None]).astype(np.float32)
    noise = rng.normal(size=(C, D)).astype(np.float32)
    mask = (rng.random(C) < 0.6).astype(np.float32)   # others pass through
    wts = (0.1 * rng.random(C)).astype(np.float32) * mask
    out, agg = cohort_clip_noise_ref(_t(u), _t(noise), _t(wts), _t(mask),
                                     clip=clip, noise_scale=noise_scale)
    out, agg = out.numpy(), agg.numpy()
    ref = j_clip_ref(u, noise, wts, mask, clip=clip, noise_scale=noise_scale)
    ker = cohort_clip_noise_kernel(u, noise, wts, mask, clip=clip,
                                   noise_scale=noise_scale, d_block=64,
                                   interpret=True)
    row_tol = 1e-6 * (np.abs(u) + noise_scale * np.abs(noise))
    for o_j, a_j in (ref, ker):
        o_j, a_j = np.asarray(o_j), np.asarray(a_j)
        if clip == 0.0:
            _assert_bitwise(o_j, out)
        assert (np.abs(o_j - out) <= row_tol).all()
        agg_tol = SUM_RTOL * (np.abs(wts) @ np.abs(o_j))
        assert (np.abs(a_j - agg) <= agg_tol + 1e-30).all()
    _assert_bitwise(out[mask == 0], u[mask == 0])


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(4)
    C, D = 9, 11
    w, U = (_t(rng.normal(size=(C, D)).astype(np.float32)) for _ in "ab")
    bc_v = _t(rng.normal(size=(2, D)).astype(np.float32))
    best = torch.zeros(C, dtype=torch.int64)
    take = torch.ones(C, dtype=torch.bool)
    eta = torch.full((C,), 0.1)
    reset()
    assert torch.equal(tick_deliver(w, U, bc_v, best, take, eta),
                       tick_deliver_ref(w, U, bc_v, best, take, eta))
    v = w[0]
    assert torch.equal(bucket_apply(v, U[:1], torch.ones(1),
                                    torch.tensor(True)),
                       bucket_apply_ref(v, U[:1], torch.ones(1),
                                        torch.tensor(True)))
    done = take.clone()
    a = tick_scatter(w, w, U, U[:2], torch.ones(2, C), torch.ones(2,
                                                                  dtype=bool),
                     done, eta, dp_on=True)
    b = tick_scatter_ref(w, w, U, U[:2], torch.ones(2, C),
                         torch.ones(2, dtype=bool), done, eta, dp_on=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    o1, _ = cohort_clip_noise(U, w, eta, done, clip=1.0, noise_scale=0.5)
    o2, _ = cohort_clip_noise_ref(U, w, eta, done, clip=1.0, noise_scale=0.5)
    assert torch.equal(o1, o2)
    key = prng.PRNGKey(3)
    o1, _ = cohort_clip_noise_prng(U, key, eta, done, clip=1.0,
                                   noise_scale=0.5)
    o2, _ = cohort_clip_noise_prng_ref(U, key, eta, done, clip=1.0,
                                       noise_scale=0.5)
    assert torch.equal(o1, o2)
    assert all(n == 0 for n in LAUNCHES.values())


def test_dispatch_refuses_other_devices():
    assert on_cuda(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        on_cuda(torch.zeros(1, device="meta"))


# --- the in-kernel noise's plain version ------------------------------------

def _tick_key(t, seed=2):
    return prng.fold_in(prng.PRNGKey(seed ^ NOISE_SALT), t)


def test_counter_stream_is_threefry_on_the_flat_index():
    C, D = 7, 33
    key = _tick_key(5)
    k0, k1 = key.tolist()
    b1, b2 = prng.counter_words(key, C * D)
    idx = torch.arange(C * D, dtype=torch.int64)
    x0, x1 = prng.threefry2x32(k0, k1, idx >> 32, idx & prng.MASK32)
    assert torch.equal(b1, x0) and torch.equal(b2, x1)
    # element by element with Python ints (no tensor broadcasting)
    for i in (0, 1, D, C * D - 1):
        assert prng.threefry2x32(k0, k1, 0, i) == (int(b1[i]), int(b2[i]))
    # x0 ^ x1 is jax's own bits for the same key and shape
    want = np.asarray(jax.random.bits(
        jnp.asarray(np.asarray(key.numpy(), np.uint32)), (C * D,)))
    assert np.array_equal(want.astype(np.int64), (b1 ^ b2).numpy())
    # Box-Muller on the top 24 bits of each word, in f32
    n = counter_normals(key, C, D).numpy().ravel()
    u1 = ((b1.numpy() >> 8).astype(np.float32) * np.float32(2.0 ** -24)
          + np.float32(2.0 ** -25))
    u2 = (b2.numpy() >> 8).astype(np.float32) * np.float32(2.0 ** -24)
    ref = (np.sqrt(np.float32(-2.0) * np.log(u1))
           * np.cos(np.float32(2.0 * np.pi) * u2))
    np.testing.assert_allclose(n, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lo,hi", [(0, 13), (5, 9), (12, 13), (3, 3)])
def test_prng_noise_at_a_row_offset_is_the_whole_draws_rows(lo, hi):
    """A rank's rows with ``row_offset``: the in-kernel stream's plain
    version gives the rows of the whole [C, D] draw, bit for bit (the
    counters are the global flat indices)."""
    rng = np.random.default_rng(8)
    C, D = 13, 29
    U = torch.tensor(rng.standard_normal((C, D)).astype(np.float32))
    mask = torch.tensor(rng.random(C) < 0.6)
    wts = torch.tensor(rng.random(C).astype(np.float32)) * mask
    key = _tick_key(9)
    whole, _ = cohort_clip_noise_prng(U, key, wts, mask, clip=1.0,
                                      noise_scale=0.8, with_agg=False)
    rows, _ = cohort_clip_noise_prng(U[lo:hi], key, wts[lo:hi],
                                     mask[lo:hi], clip=1.0, noise_scale=0.8,
                                     with_agg=False, row_offset=lo)
    assert torch.equal(rows.view(torch.int32),
                       whole[lo:hi].view(torch.int32))
    n = counter_normals(key, hi - lo, D, start=lo * D)
    assert torch.equal(n, counter_normals(key, C, D)[lo:hi])


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_prng_plain_version_without_noise_is_the_operand_one(clip):
    rng = np.random.default_rng(6)
    C, D = 13, 29
    u = (0.2 * rng.normal(size=(C, D))).astype(np.float32)
    mask = rng.random(C) < 0.5
    wts = (0.1 * rng.random(C)).astype(np.float32) * mask
    got = cohort_clip_noise_prng_ref(_t(u), _tick_key(3), _t(wts),
                                     _t(mask), clip=clip, noise_scale=0.0)
    want = cohort_clip_noise_ref(_t(u), None, _t(wts), _t(mask), clip=clip,
                                 noise_scale=0.0)
    for a, b in zip(got, want):
        _assert_bitwise(a.numpy(), b.numpy())
    out, _ = cohort_clip_noise_prng_ref(_t(u), _tick_key(3), _t(wts),
                                        _t(mask), clip=clip,
                                        noise_scale=0.8)
    # pass-through rows: u * 1 + (0.8 * 0) * n is u, bit for bit
    _assert_bitwise(out.numpy()[~mask], u[~mask])


def test_prng_normals_pass_the_reference_distribution_test():
    """tests/test_tick_fused.py::test_in_kernel_prng_noise_chi_square,
    on the plain version (the same C, D and statistic)."""
    C, D = 64, 512
    out, _ = cohort_clip_noise_prng(torch.zeros(C, D), _tick_key(0, seed=5),
                                    torch.ones(C), torch.ones(C), clip=0.0,
                                    noise_scale=1.0)
    s = out.numpy().ravel()
    assert abs(s.mean()) < 0.02 and abs(s.std() - 1.0) < 0.02
    edges = np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0])
    cdf = np.vectorize(
        lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0))))
    probs = np.diff(np.concatenate([[0.0], cdf(edges), [1.0]]))
    counts, _ = np.histogram(s, bins=np.concatenate(
        [[-np.inf], edges, [np.inf]]))
    expected = probs * s.size
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    df = len(probs) - 1
    assert chi2 < df + 5.0 * math.sqrt(2.0 * df), (chi2, counts)


def test_prng_normals_of_adjacent_ticks_are_uncorrelated():
    C, D = 64, 512
    a = counter_normals(_tick_key(10), C, D).numpy().ravel()
    b = counter_normals(_tick_key(11), C, D).numpy().ravel()
    assert abs(float(np.corrcoef(a, b)[0, 1])) < 0.02
    # neighbouring elements of one draw too
    assert abs(float(np.corrcoef(a[:-1], a[1:])[0, 1])) < 0.02


# --- with_agg=False and pass-through rows (both plain versions) -------------

def _clip_noise_pair(prng_noise, u, key, noise, wts, mask, **kw):
    if prng_noise:
        return cohort_clip_noise_prng(u, key, wts, mask, **kw)
    return cohort_clip_noise(u, noise, wts, mask, **kw)


@pytest.mark.parametrize("prng_noise", [True, False])
@pytest.mark.parametrize("clip,noise_scale", [(1.0, 0.8), (0.0, 0.8),
                                              (1.0, 0.0)])
def test_without_agg_out_is_bitwise_and_agg_is_none(prng_noise, clip,
                                                     noise_scale):
    rng = np.random.default_rng(8)
    C, D = 11, 37
    u = _t((0.3 * rng.normal(size=(C, D))).astype(np.float32))
    noise = _t(rng.normal(size=(C, D)).astype(np.float32))
    mask = _t(rng.random(C) < 0.5)
    wts = _t((0.1 * rng.random(C)).astype(np.float32)) * mask
    kw = dict(clip=clip, noise_scale=noise_scale)
    o1, a1 = _clip_noise_pair(prng_noise, u, _tick_key(4), noise, wts, mask,
                              **kw)
    o2, a2 = _clip_noise_pair(prng_noise, u, _tick_key(4), noise, wts, mask,
                              with_agg=False, **kw)
    assert a1 is not None and tuple(a1.shape) == (D,)
    assert a2 is None
    _assert_bitwise(o1.numpy(), o2.numpy())


@pytest.mark.parametrize("prng_noise", [True, False])
def test_pass_through_rows_keep_u_and_signed_zeros_take_the_noise_sign(
        prng_noise):
    """A pass-through row is ``u * 1 + (noise_scale * 0) * n``: every
    element is u's bits, except -0.0, which becomes -0.0 + (+0.0 * n):
    +0.0 where n > 0, -0.0 where n < 0 (the oracle of the kernel's copy
    of pass-through rows)."""
    rng = np.random.default_rng(9)
    C, D, ns = 6, 64, 0.8
    u = (0.3 * rng.normal(size=(C, D))).astype(np.float32)
    u[:, ::4] = -0.0
    u[:, 1::4] = 0.0
    mask = np.array([1, 0, 0, 1, 0, 1], np.float32)
    key = _tick_key(6)
    n = (counter_normals(key, C, D).numpy() if prng_noise
         else rng.normal(size=(C, D)).astype(np.float32))
    out, _ = _clip_noise_pair(prng_noise, _t(u), key, _t(n),
                              _t(np.ones(C, np.float32)), _t(mask),
                              clip=1.0, noise_scale=ns)
    out = out.numpy()
    pt = mask == 0
    want = u[pt] + (np.float32(ns) * np.float32(0.0)) * n[pt]
    _assert_bitwise(out[pt], want)
    neg0 = _bits(u[pt]) == np.int32(-2 ** 31)
    assert neg0.sum() == 3 * 16
    assert (_bits(out[pt])[neg0] == np.where(n[pt][neg0] > 0, 0,
                                             np.int32(-2 ** 31))).all()
    _assert_bitwise(out[pt][~neg0], u[pt][~neg0])
