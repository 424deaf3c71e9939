"""Card-only checks of the port's CUDA kernels (marker ``cuda``; they skip
without a CUDA device).  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel against its plain version at ragged shapes (C and D not
multiples of any tile): bitwise where the kernel keeps the plain
version's rounding, SUM_RTOL * sum|terms| where it reorders a sum over
clients; ``bucket_apply`` also at FedAsync's ``A = R`` with decay
weights != 1 and ``tick_scatter`` at its ``G = L * R``; the in-kernel
noise's stream bit for bit and its rows within ROW_RTOL (CUDA's
logf/cosf against PyTorch's log/cos); and the slice on the card against
the same slice on the CPU.
"""
import numpy as np
import pytest
import torch

SUM_RTOL = 1e-5
ROW_RTOL = 1e-6

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("C,D", [(1, 1), (37, 13), (130, 785)])
def test_kernels_match_plain_versions(dev, C, D):
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.cohort_dp import (cohort_clip_noise,
                                               cohort_clip_noise_ref)
    from repro_torch.kernels.tick_fused import (bucket_apply,
                                                bucket_apply_ref,
                                                tick_deliver,
                                                tick_deliver_ref,
                                                tick_scatter,
                                                tick_scatter_ref)
    g = torch.Generator(device=dev).manual_seed(C * 1000 + D)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    ru = lambda *s: torch.rand(s, generator=g, device=dev)   # noqa: E731
    reset()
    v, rows = rn(D), rn(1, D)
    v[:1], rows[0, :1] = -0.0, -0.0
    for flag in (True, False):
        fl = torch.tensor(flag, device=dev)
        assert _bits_equal(bucket_apply(v, rows, torch.ones(1, device=dev),
                                        fl),
                           bucket_apply_ref(v, rows,
                                            torch.ones(1, device=dev), fl))
    w, U, bc = rn(C, D), rn(C, D), rn(4, D)
    best = torch.randint(0, 4, (C,), generator=g, device=dev)
    take, eta = ru(C) < 0.5, 0.1 * ru(C)
    assert _bits_equal(tick_deliver(w, U, bc, best, take, eta),
                       tick_deliver_ref(w, U, bc, best, take, eta))
    sent, upd, done = rn(C, D), rn(3, D), ru(C) < 0.5
    masks = [done, ~done, torch.zeros_like(done)]
    wgt = torch.stack([eta * m.float() for m in masks])
    any_g = torch.stack([m.any() for m in masks])
    k = tick_scatter(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    p = tick_scatter_ref(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    assert _bits_equal(k[0], p[0]) and _bits_equal(k[1], p[1])
    assert _bits_equal(k[2][2], upd[2])
    tol = SUM_RTOL * (wgt.abs() @ sent.abs())
    assert bool(((k[2] - p[2]).abs() <= tol + 1e-30).all())
    noise = rn(C, D)
    for clip in (1.0, 0.0):
        o, a = cohort_clip_noise(U * 0.05, noise, eta * done, done,
                                 clip=clip, noise_scale=0.8)
        po, pa = cohort_clip_noise_ref(U * 0.05, noise, eta * done, done,
                                       clip=clip, noise_scale=0.8)
        if clip == 0.0:
            assert _bits_equal(o, po)
        row_tol = 1e-6 * (0.05 * U.abs() + 0.8 * noise.abs())
        assert bool(((o - po).abs() <= row_tol).all())
        agg_tol = SUM_RTOL * ((eta * done).abs() @ po.abs())
        assert bool(((a - pa).abs() <= agg_tol + 1e-30).all())
    torch.cuda.synchronize()
    assert LAUNCHES == {"bucket_apply": 2, "tick_deliver": 1,
                        "tick_scatter": 1, "cohort_clip_noise": 2,
                        "cohort_clip_noise_prng": 0}


@pytest.mark.parametrize("C,D", [(1, 1), (37, 13), (130, 785)])
def test_fedasync_shapes_match_plain_versions(dev, C, D):
    """bucket_apply at A = R = 4 with decay weights != 1 and tick_scatter
    at G = L * R = 8 (L = 2 ring slots x R = 4 sender-k strata)."""
    from repro_torch.kernels.tick_fused import (bucket_apply,
                                                bucket_apply_ref,
                                                tick_scatter,
                                                tick_scatter_ref)
    g = torch.Generator(device=dev).manual_seed(C * 7 + D)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    ru = lambda *s: torch.rand(s, generator=g, device=dev)   # noqa: E731
    R, L = 4, 2
    v, rows = rn(D), rn(R, D)
    dec = 0.6 * (torch.arange(R, device=dev, dtype=torch.float32)
                 + 1.0) ** -0.5
    rows[2] = 0.0                       # an empty stratum
    for flag in (True, False):
        fl = torch.tensor(flag, device=dev)
        k = bucket_apply(v, rows, dec, fl)
        p = bucket_apply_ref(v, rows, dec, fl)
        tol = SUM_RTOL * (dec.abs() @ rows.abs())
        assert bool(((k - p).abs() <= tol + 1e-30).all())
        assert _bits_equal(k, bucket_apply(v, rows, dec, fl))
    assert _bits_equal(bucket_apply(v, rows, dec, torch.tensor(False,
                                                                device=dev)),
                       v)
    sent, w, U = rn(C, D), rn(C, D), rn(C, D)
    upd = rn(L * R, D)
    done, eta = ru(C) < 0.6, 0.1 * ru(C)
    slot = torch.randint(0, L, (C,), generator=g, device=dev)
    kmod = torch.randint(0, R, (C,), generator=g, device=dev)
    masks = torch.stack([done & (slot == sl) & (kmod == r)
                         for sl in range(L) for r in range(R)])
    wgt = eta[None, :] * masks.float()
    any_g = masks.any(1)
    k = tick_scatter(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    p = tick_scatter_ref(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    assert _bits_equal(k[0], p[0]) and _bits_equal(k[1], p[1])
    tol = SUM_RTOL * (wgt.abs() @ sent.abs())
    assert bool(((k[2] - p[2]).abs() <= tol + 1e-30).all())
    for gi in range(L * R):
        if not bool(any_g[gi]):
            assert _bits_equal(k[2][gi], upd[gi])
    k2 = tick_scatter(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    assert all(_bits_equal(a, b) for a, b in zip(k, k2))


@pytest.mark.parametrize("C,D", [(1, 1), (37, 13), (130, 785)])
def test_in_kernel_noise_matches_plain_version(dev, C, D):
    from repro_torch import prng
    from repro_torch.analysis.salts import NOISE_SALT
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.cohort_dp import (cohort_clip_noise_prng,
                                               cohort_clip_noise_prng_ref,
                                               counter_normals)
    from repro_torch.kernels.cohort_dp.kernel import prng_words_probe
    g = torch.Generator(device=dev).manual_seed(C * 13 + D)
    key = prng.fold_in(prng.PRNGKey(2 ^ NOISE_SALT), 7)
    w0, w1 = prng_words_probe(key, C * D, dev)
    p0, p1 = prng.counter_words(key, C * D, device=dev)
    assert torch.equal(w0, p0) and torch.equal(w1, p1)
    u = 0.05 * torch.randn((C, D), generator=g, device=dev)
    mask = torch.rand((C,), generator=g, device=dev) < 0.6
    wts = 0.1 * torch.rand((C,), generator=g, device=dev) * mask
    n = counter_normals(key, C, D, device=dev)
    reset()
    for clip in (1.0, 0.0):
        o, a = cohort_clip_noise_prng(u, key, wts, mask, clip=clip,
                                      noise_scale=0.8)
        o2, a2 = cohort_clip_noise_prng(u, key, wts, mask, clip=clip,
                                        noise_scale=0.8)
        po, pa = cohort_clip_noise_prng_ref(u, key, wts, mask, clip=clip,
                                            noise_scale=0.8)
        assert _bits_equal(o, o2) and _bits_equal(a, a2)
        row_tol = ROW_RTOL * (u.abs() + 0.8 * n.abs())
        assert bool(((o - po).abs() <= row_tol).all())
        agg_tol = SUM_RTOL * (wts.abs() @ po.abs())
        assert bool(((a - pa).abs() <= agg_tol + 1e-30).all())
        assert _bits_equal(o[~mask], u[~mask])
    torch.cuda.synchronize()
    assert LAUNCHES["cohort_clip_noise_prng"] == 4


@pytest.mark.parametrize("scenario,strategy,dp_rng", [
    ("uniform", None, "operand"),
    ("mobile_diurnal", "fedasync", "in_kernel"),
    ("iot_straggler", {"kind": "fedbuff", "buffer_size": 3}, "in_kernel"),
])
def test_slice_on_the_card_matches_the_cpu(dev, scenario, strategy, dp_rng):
    import repro_torch as rt
    X, y = rt.make_binary_dataset(300, 12, seed=9, noise=0.3)
    out = {}
    for d in (dev, torch.device("cpu")):
        task = rt.LogRegTask(X, y, l2=1.0 / 300, dp_clip=0.1, dp_sigma=8.0,
                             sample_seed=21)
        sim = rt.DeviceCohortSimulator(
            task, n_clients=6, sizes_per_client=[4, 6, 8],
            round_stepsizes=[0.1, 0.08, 0.06], d=2, seed=2, block=4,
            dp_round_clip=1.0, scenario=scenario, strategy=strategy,
            dp_rng=dp_rng, device=d)
        res = sim.run(max_rounds=3)
        out[d.type] = (res["telemetry"].ops,
                       [h["loss"] for h in res["history"]])
    assert out["cuda"][0] == out["cpu"][0]
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5,
                               atol=1e-7)
