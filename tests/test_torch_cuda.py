"""Card-only checks of the port's CUDA kernels (marker ``cuda``; they skip
without a CUDA device).  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel against its plain version at ragged shapes (C and D not
multiples of any tile): bitwise where the kernel keeps the plain
version's rounding, SUM_RTOL * sum|terms| where it reorders a sum over
clients; and the slice on the card against the same slice on the CPU.
"""
import numpy as np
import pytest
import torch

SUM_RTOL = 1e-5

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
                        "tick_scatter": 1, "cohort_clip_noise": 2}


def test_slice_on_the_card_matches_the_cpu(dev):
    import repro_torch as rt
    X, y = rt.make_binary_dataset(300, 12, seed=9, noise=0.3)
    out = {}
    for d in (dev, torch.device("cpu")):
        task = rt.LogRegTask(X, y, l2=1.0 / 300, dp_clip=0.1, dp_sigma=8.0,
                             sample_seed=21)
        sim = rt.DeviceCohortSimulator(
            task, n_clients=6, sizes_per_client=[4, 6, 8],
            round_stepsizes=[0.1, 0.08, 0.06], d=2, seed=2, block=4,
            dp_round_clip=1.0, device=d)
        res = sim.run(max_rounds=3)
        out[d.type] = (res["telemetry"].ops,
                       [h["loss"] for h in res["history"]])
    assert out["cuda"][0] == out["cpu"][0]
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5,
                               atol=1e-7)
