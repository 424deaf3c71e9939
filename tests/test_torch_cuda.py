"""Card-only checks of the port's CUDA kernels (marker ``cuda``; they skip
without a CUDA device).  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel against its plain version at ragged shapes (C and D not
multiples of any tile): bitwise where the kernel keeps the plain
version's rounding, SUM_RTOL * sum|terms| where it reorders a sum over
clients; ``bucket_apply`` also at FedAsync's ``A = R`` with decay
weights != 1 and ``tick_scatter`` at its ``G = L * R``; the in-kernel
noise's stream bit for bit and its rows within ROW_RTOL (CUDA's
logf/cosf against PyTorch's log/cos); both clip+noise kernels at ragged
C * D with 0, half and all rows masked, signed zeros in pass-through
rows and agg on or off; the slice on the card against
the same slice on the CPU; and the model-scale kernels (DP clip,
flash attention, SSD scan) against their plain versions at ragged
shapes, f32 and bf16, within the reference suite's tolerances; the bf16
attention kernel also at the shapes its tensor-core tiles make hard, and
its wgmma operand forms (the layout probe) against torch.matmul.
The row-streaming kernels (``tick_scatter``, ``clip_accumulate``) are
also held bit for bit to their order-exact twins at ragged and at the
paths' shapes, from 16-byte aligned and unaligned base pointers, and a
block partial dropped from their finish pass must read above SUM_RTOL.
The server's step (``server_apply``, one launch a tick) is held bit for
bit to its twin ``server_apply_ref`` on the card, on every output and
every row it writes in place, for the three strategies with and without
a far tier, the flags set and clear and 0-2 fired broadcast rows, with
-0.0 planted, at ragged, 16-byte-group and unaligned layouts and at a
model-sized D.
The logistic-regression client block (``cohort_logreg_block``) is held
bit for bit to its twin ``logreg_block_ref`` at the path's shape and at
small and ragged D, with n = 0, 1, b and ragged, clip and l2 on and off,
and through a rank's row view of the task; at d 784 to the eager loop it
replaced, its add order (``lane_sum``) to torch's row sum.
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
                        "tick_scatter": 1, "tick_scatter_rows": 0,
                        "tick_scatter_finish": 0, "cohort_clip_noise": 2,
                        "cohort_clip_noise_prng": 0, "clip_accumulate": 0,
                        "flash_attention": 0, "ssd_scan": 0,
                        "cohort_logreg_block": 0}


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


@pytest.mark.parametrize("D", [1, 3, 785, 1024])
@pytest.mark.parametrize("C", [1, 63, 65, 16385])
def test_clip_noise_kernels_at_ragged_shapes_and_masked_shares(dev, C, D):
    """Both clip+noise kernels against their plain versions at ragged
    C * D, with 0, half and all rows masked, clip on and off, agg asked
    for or not, and signed zeros in u: pass-through rows are the plain
    version's bits (u, but -0.0 takes the sign of 0 * n); two launches
    give the same bits; without agg, out is the same and agg None."""
    from repro_torch import prng
    from repro_torch.analysis.salts import NOISE_SALT
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.cohort_dp import (cohort_clip_noise,
                                               cohort_clip_noise_prng,
                                               cohort_clip_noise_prng_ref,
                                               cohort_clip_noise_ref,
                                               counter_normals)
    g = torch.Generator(device=dev).manual_seed(C * 31 + D)
    key = prng.fold_in(prng.PRNGKey(2 ^ NOISE_SALT), 9)
    u = 0.05 * torch.randn((C, D), generator=g, device=dev)
    u[:, ::5] = -0.0
    u[:, 1::5] = 0.0
    n = counter_normals(key, C, D, device=dev)
    noise = torch.randn((C, D), generator=g, device=dev)
    ns = 0.8
    reset()
    for share in (0.0, 0.5, 1.0):
        mask = torch.rand((C,), generator=g, device=dev) < share
        wts = 0.1 * torch.rand((C,), generator=g, device=dev) * mask
        for clip in (1.0, 0.0):
            for fn, ref, nz in ((cohort_clip_noise_prng,
                                 cohort_clip_noise_prng_ref, key),
                                (cohort_clip_noise, cohort_clip_noise_ref,
                                 noise)):
                kw = dict(clip=clip, noise_scale=ns)
                o, a = fn(u, nz, wts, mask, **kw)
                o2, a2 = fn(u, nz, wts, mask, **kw)
                o3, a3 = fn(u, nz, wts, mask, with_agg=False, **kw)
                po, pa = ref(u, nz, wts, mask, **kw)
                assert a3 is None
                assert _bits_equal(o, o2) and _bits_equal(a, a2)
                assert _bits_equal(o, o3)
                assert _bits_equal(o[~mask], po[~mask])
                if fn is cohort_clip_noise and clip == 0.0:
                    assert _bits_equal(o, po)
                dn = n if fn is cohort_clip_noise_prng else noise
                row_tol = ROW_RTOL * (u.abs() + ns * dn.abs())
                assert bool(((o - po).abs() <= row_tol).all())
                agg_tol = SUM_RTOL * (wts.abs() @ po.abs())
                assert bool(((a - pa).abs() <= agg_tol + 1e-30).all())
    torch.cuda.synchronize()
    assert LAUNCHES["cohort_clip_noise_prng"] == 18
    assert LAUNCHES["cohort_clip_noise"] == 18


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


# the reference suite's tolerances (tests/test_kernels.py)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("N,D", [(1, 1), (4, 300), (37, 13), (130, 785)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clip_accumulate_matches_plain_version(dev, N, D, dtype):
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.dp_clip import (clip_accumulate,
                                             clip_accumulate_ref)
    g = torch.Generator(device=dev).manual_seed(N * 1000 + D)
    G = (3.0 * torch.randn((N, D), generator=g, device=dev)).to(dtype)
    reset()
    k = clip_accumulate(G, clip=0.5)
    assert k.dtype == torch.float32 and tuple(k.shape) == (D,)
    assert _bits_equal(k, clip_accumulate(G, clip=0.5))
    p = clip_accumulate_ref(G, 0.5)
    tol = SUM_RTOL * clip_accumulate_ref(G.abs(), 0.5)
    assert bool(((k - p).abs() <= tol + 1e-30).all())
    torch.cuda.synchronize()
    assert LAUNCHES["clip_accumulate"] == 2


@pytest.mark.parametrize("B,S,H,KV,hd,kw", [
    (2, 256, 4, 2, 64, {}),
    (1, 128, 2, 1, 128, {}),                                   # MQA
    (2, 200, 4, 2, 64, {"causal": False}),                     # odd S
    (1, 130, 4, 1, 128, {"window": 64, "softcap": 30.0}),
    (1, 77, 2, 2, 32, {"softcap": 50.0}),
    (2, 256, 8, 8, 256, {"window": 100}),
    (1, 70, 2, 1, 100, {"causal": False, "window": 9}),        # odd hd
    # shapes the bf16 kernel's tiles make hard (128-row q tiles, 64-key
    # kv tiles, 16-column k-steps, zero fill beyond hd and S)
    (1, 1, 4, 2, 64, {}),                                      # S = 1
    (2, 1, 2, 1, 256, {"causal": False}),
    (1, 127, 4, 2, 64, {}),                                    # q tile - 1
    (2, 129, 4, 2, 128, {}),                                   # q tile + 1
    (1, 129, 2, 2, 64, {"causal": False, "softcap": 20.0}),
    (1, 100, 2, 1, 8, {}),                                     # hd 8
    (1, 150, 4, 2, 100, {"softcap": 30.0}),                    # hd 100
    (1, 200, 8, 1, 64, {}),                                    # KV = 1
    (1, 300, 4, 2, 64, {"window": 9}),                         # window < tile
    (1, 1024, 8, 4, 256, {"window": 300, "softcap": 50.0}),
    # shapes the f32 kernel's tiles make hard (64-row q tiles, 256-key kv
    # tiles, 32-column K slabs and 32-key V slabs, hd / 32 output columns
    # per lane, 4-byte copies where hd % 4 != 0)
    (1, 63, 4, 2, 8, {}),                                      # q tile - 1
    (1, 65, 2, 1, 100, {"softcap": 50.0}),                     # q tile + 1
    (2, 255, 4, 1, 256, {"window": 100}),                      # kv tile - 1
    (1, 257, 4, 2, 256, {"softcap": 30.0, "window": 9}),       # kv tile + 1
    (1, 257, 2, 2, 100, {"causal": False}),
    (1, 256, 2, 2, 8, {"causal": False, "softcap": 50.0}),
    (1, 64, 2, 1, 256, {}),
    (1, 513, 8, 1, 8, {"window": 200, "softcap": 20.0}),
    (1, 300, 2, 1, 37, {"window": 255}),                       # hd % 4 != 0
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_version(dev, B, S, H, KV, hd, kw,
                                               dtype):
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.flash_attention import attend, attention_ref
    g = torch.Generator(device=dev).manual_seed(S * 7 + hd)
    q, k, v = (torch.randn((B, S, h, hd), generator=g, device=dev)
               .to(dtype) for h in (H, KV, KV))
    reset()
    o = attend(q, k, v, **kw)
    assert o.dtype == dtype and o.shape == q.shape
    assert _bits_equal(o.float(), attend(q, k, v, **kw).float())
    p = attention_ref(q, k, v, **kw).float()
    tol = ATTN_TOL[dtype]
    assert bool(((o.float() - p).abs() <= tol + tol * p.abs()).all())
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 2


@pytest.mark.parametrize("form", [0, 1, 2, 3])
def test_wgmma_layout_probe_matches_matmul(dev, form):
    """The bf16 kernel's wgmma operand forms (A shared K-major or in
    registers, B shared K-major or MN-major) through its swizzled copies,
    descriptors and fragment maps, against torch.matmul of the same bf16
    tiles in f32, within 1e-5 * sum|terms|."""
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.flash_attention.kernel import (PROBE_FORMS,
                                                            wgmma_probe)
    a_shape, b_shape, n = PROBE_FORMS[form]
    g = torch.Generator(device=dev).manual_seed(form)
    a = torch.randn(a_shape, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(b_shape, generator=g, device=dev).to(torch.bfloat16)
    reset()
    d = wgmma_probe(a, b, form)
    af, bf = a.float(), b.float()
    if form in (0, 2):                      # B K-major: d = a b^T
        bf = bf.T
    want = af @ bf
    tol = SUM_RTOL * (af.abs() @ bf.abs())
    assert d.shape == (64, n)
    assert bool(((d - want).abs() <= tol).all())
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 0


def _ssd_case(b, s, h, p, n, chunk, init, a=None):
    """A case of the SSD tests; a: every A[h] = a (strong decay) instead
    of -exp(0.1 z)."""
    vals = (b, s, h, p, n, chunk, init)
    cid = "-".join(map(str, vals)) + ("" if a is None else f"-A{a:g}")
    return pytest.param(*vals, a, id=cid)


def _ssd_inputs(dev, b, s, h, p, n, init, a, dtype):
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(s * 3 + n)
    rn = lambda *sh: torch.randn(sh, generator=g, device=dev)  # noqa: E731
    x = rn(b, s, h, p).to(dtype)
    dt = F.softplus(rn(b, s, h))
    A = -torch.exp(0.1 * rn(h)) if a is None \
        else torch.full((h,), float(a), device=dev)
    B, C = rn(b, s, n).to(dtype), rn(b, s, n).to(dtype)
    h0 = rn(b, h, n, p) if init else None
    return x, dt, A, B, C, h0


def _rel(got, want):
    err = (got.float() - want.float()).abs().max()
    return float(err / (want.float().abs().max() + 1e-9))


SSD_CASES = [
    _ssd_case(2, 256, 4, 32, 16, 64, False),
    _ssd_case(1, 128, 2, 64, 32, 128, False),                  # nc = 1
    _ssd_case(2, 192, 3, 32, 64, 64, False),
    _ssd_case(1, 100, 2, 32, 16, 64, False),                   # odd s
    _ssd_case(2, 130, 3, 64, 128, 128, True),                  # mamba2 n, p
    _ssd_case(1, 50, 2, 64, 12, 128, False),                   # s < chunk
    # the chunk-parallel kernels' edges: mamba2-780m's heads and widths at
    # s = 2 chunks + 1, p = 32, an initial state, decay underflowing to 0,
    # n and p off the 32-step slabs and the 128 x 64 output tiles
    _ssd_case(1, 257, 48, 64, 128, 128, False),
    _ssd_case(2, 129, 4, 32, 128, 128, True),
    _ssd_case(1, 300, 3, 64, 128, 128, True, a=-8.0),
    _ssd_case(2, 200, 2, 32, 16, 64, False, a=-8.0),
    _ssd_case(1, 90, 2, 72, 40, 32, True),
    _ssd_case(1, 300, 2, 16, 136, 256, False),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,init,a", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_matches_plain_version(dev, b, s, h, p, n, chunk, init, a,
                                        dtype):
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    x, dt, A, B, C, h0 = _ssd_inputs(dev, b, s, h, p, n, init, a, dtype)
    reset()
    y, fin = ssd_scan(x, dt, A, B, C, chunk, h0)
    y2, fin2 = ssd_scan(x, dt, A, B, C, chunk, h0)
    assert y.dtype == dtype and fin.dtype == torch.float32
    assert _bits_equal(y.float(), y2.float()) and _bits_equal(fin, fin2)
    yr, fr = ssd_chunked(x, dt, A, B, C, chunk, h0)
    for got, want in ((y, yr), (fin, fr)):
        assert _rel(got, want) < SSD_TOL[dtype]
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == 2


@pytest.mark.parametrize("phase", ["cb", "chunk_state", "state_passing",
                                   "chunk_scan"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,init,a", [
    _ssd_case(1, 257, 48, 64, 128, 128, True),
    _ssd_case(2, 100, 3, 32, 16, 64, False),
    _ssd_case(1, 300, 3, 64, 128, 128, True, a=-8.0),
    _ssd_case(1, 90, 2, 72, 40, 32, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_phases_match_plain_phases(dev, phase, b, s, h, p, n,
                                              chunk, init, a, dtype):
    """Each of the four SSD kernels on the plain phases' inputs against
    its plain phase, so that a fault shows its phase: f32 intermediates
    within SSD_TOL's f32 limit of max |ref|, y within the dtype's."""
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.ssd_scan import (ssd_cb, ssd_chunk_outputs,
                                              ssd_chunk_states, ssd_chunks,
                                              ssd_state_passing)
    from repro_torch.kernels.ssd_scan.kernel import ssd_phase
    x, dt, A, B, C, h0 = _ssd_inputs(dev, b, s, h, p, n, init, a, dtype)
    xf, dtf, Af, Bc, Cc = ssd_chunks(x, dt, A, B, C, chunk)
    CB = ssd_cb(Cc, Bc)
    cum, states = ssd_chunk_states(xf, dtf, Af, Bc)
    prev, final = ssd_state_passing(states, cum, h0)
    yc = ssd_chunk_outputs(xf, dtf, cum, Cc, CB, prev)
    cum_k = cum.permute(0, 1, 3, 2).double().contiguous()   # (b, nc, h, Q)
    f32 = SSD_TOL[torch.float32]
    reset()
    if phase == "cb":
        got = ssd_phase(phase, x, dt, A, B, C, chunk)["cb"]
        assert _rel(torch.tril(got), torch.tril(CB)) < f32
    elif phase == "chunk_state":
        out = ssd_phase(phase, x, dt, A, B, C, chunk)
        assert _rel(out["cum"], cum_k) < f32
        assert _rel(out["states"], states) < f32
    elif phase == "state_passing":
        out = ssd_phase(phase, x, dt, A, B, C, chunk, h0, cum=cum_k,
                        states=states)
        assert _rel(out["states"], prev) < f32
        assert _rel(out["final"], final) < f32
    else:
        out = ssd_phase(phase, x, dt, A, B, C, chunk, cb=CB, cum=cum_k,
                        states=prev)
        want = yc.reshape(b, -1, h, p)[:, :s]
        assert out["y"].dtype == dtype
        assert _rel(out["y"], want) < SSD_TOL[dtype]
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == 0


def _scatter_case(dev, C, D, G, share, layout, seed):
    """tick_scatter's operands on the card: a -0.0 column onto -0.0 ring
    entries, G - 1 ring rows taking random subsets of the done rows, the
    last one (G >= 2) empty.  layout "offset": sent, w and U are row
    views one row into larger tensors, so their base pointers are 16-byte
    aligned only where D % 4 == 0 (the kernel's 4-byte copies)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    extra = 1 if layout == "offset" else 0

    def rows():
        return torch.randn((C + extra, D), generator=g, device=dev)[extra:]
    sent, w, U = rows(), rows(), rows()
    upd = torch.randn((G, D), generator=g, device=dev)
    sent[:, 0], upd[:, 0] = -0.0, -0.0
    done = torch.rand(C, generator=g, device=dev) < share
    eta = 0.1 * torch.rand(C, generator=g, device=dev)
    pick = torch.randint(0, max(G - 1, 1), (C,), generator=g, device=dev)
    masks = torch.stack([done & (pick == r) for r in range(G)])
    if G >= 2:
        masks[G - 1] = False
    wgt = eta[None, :] * masks.float()
    return sent, w, U, upd, wgt, masks.any(1), done, eta


@pytest.mark.parametrize("C,D,G,share,dp_on", [
    (1, 1, 1, 1.0, True), (3, 13, 2, 0.5, True), (4, 13, 2, 1.0, True),
    (5, 785, 8, 0.0, True), (1100, 785, 8, 0.5, True),
    (1100, 13, 32, 0.5, False), (37, 2500, 2, 0.5, True),
    (16384, 785, 2, 0.5, True), (16384, 785, 8, 0.5, True),
    (16384, 785, 2, 0.004, True)])
@pytest.mark.parametrize("layout", ["aligned", "offset"])
def test_tick_scatter_matches_its_twin_bitwise(dev, C, D, G, share, dp_on,
                                               layout):
    """The kernel against tick_scatter_twin (its add order, on the CPU)
    bit for bit; w' and U' against tick_scatter_ref bitwise and the ring
    rows within SUM_RTOL; an empty ring row untouched; two launches
    bitwise.  C 16384 at G 2 and 8: the main run's and FedAsync's shapes
    (0.4% done: a scenario tick); D 2500: three column slabs."""
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.tick_fused import (tick_scatter,
                                                tick_scatter_ref,
                                                tick_scatter_twin)
    args = _scatter_case(dev, C, D, G, share, layout, seed=C + D + G)
    reset()
    k = tick_scatter(*args, dp_on=dp_on)
    k2 = tick_scatter(*args, dp_on=dp_on)
    torch.cuda.synchronize()
    assert LAUNCHES["tick_scatter"] == 2
    assert all(_bits_equal(a, b) for a, b in zip(k, k2))
    twin = tick_scatter_twin(*(a.cpu() for a in args), dp_on=dp_on)
    assert all(_bits_equal(a.cpu(), b) for a, b in zip(k, twin))
    p = tick_scatter_ref(*args, dp_on=dp_on)
    assert _bits_equal(k[0], p[0]) and _bits_equal(k[1], p[1])
    sent, upd, wgt, any_g = args[0], args[3], args[4], args[5]
    tol = SUM_RTOL * (wgt.abs() @ sent.abs())
    assert bool(((k[2] - p[2]).abs() <= tol + 1e-30).all())
    for gi in range(G):
        if not bool(any_g[gi]):
            assert _bits_equal(k[2][gi], upd[gi])
    assert bool(torch.signbit(k[2][:, 0]).all())


@pytest.mark.parametrize("C,D,G,P", [
    (20, 13, 2, 2), (20, 785, 8, 4), (2, 13, 2, 2), (4, 13, 2, 4),
    (1160, 785, 3, 4), (16384, 785, 8, 1), (16384, 785, 2, 4)])
def test_scatter_passes_cut_over_ranks_match_the_fused_kernel(dev, C, D, G,
                                                              P):
    """tick_scatter's two entry points as a cut client axis runs them
    (each rank's rows from their offset in the whole axis's partition, a
    straddling block continued from the carry, the complete blocks'
    partials finished together, past the ring rows a row of sums alone)
    bit for bit the fused launch and their twins."""
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.tick_fused import (scatter_partition,
                                                tick_scatter,
                                                tick_scatter_finish,
                                                tick_scatter_finish_twin,
                                                tick_scatter_rows,
                                                tick_scatter_rows_twin)
    sent, w, U, upd, wgt, any_g, done, eta = _scatter_case(
        dev, C, D, G, 0.5, "aligned", seed=C + G)
    fused = tick_scatter(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    rb, nblk = scatter_partition(C)
    n = C // P
    reset()
    parts, carry, wo, uo = [], None, torch.empty_like(w), torch.empty_like(U)
    for r in range(P):
        lo, hi = r * n, (r + 1) * n
        a = (sent[lo:hi], w[lo:hi], U[lo:hi], wgt[:, lo:hi], done[lo:hi],
             eta[lo:hi])
        kw = dict(dp_on=True, rows_per_block=rb, row_offset=lo % rb,
                  carry=carry if lo % rb else None)
        _, _, p = tick_scatter_rows(*a, out=(wo[lo:hi], uo[lo:hi]), **kw)
        tw = tick_scatter_rows_twin(*(x.cpu() for x in a), **{
            **kw, "carry": None if kw["carry"] is None
            else kw["carry"].cpu()})
        assert _bits_equal(p.cpu(), tw[2])
        carry = None
        if hi < C and hi % rb:
            carry, p = p[-1].contiguous(), p[:-1]
        parts.append(p)
    partial = torch.cat(parts)
    assert partial.shape[0] == nblk
    out = tick_scatter_finish(partial, upd, any_g)
    torch.cuda.synchronize()
    assert LAUNCHES["tick_scatter_rows"] == P
    assert LAUNCHES["tick_scatter_finish"] == 1
    assert _bits_equal(out, fused[2])
    assert _bits_equal(wo, fused[0]) and _bits_equal(uo, fused[1])
    alone = tick_scatter_finish(partial, upd[:1], None)
    assert _bits_equal(alone.cpu(), tick_scatter_finish_twin(
        partial.cpu(), upd[:1].cpu(), None))


@pytest.mark.parametrize("C,D,lo,hi", [(13, 29, 5, 9), (16384, 785, 4096,
                                                         8192),
                                       (1160, 785, 870, 1160)])
def test_in_kernel_noise_at_a_row_offset_is_the_whole_draws_rows(dev, C, D,
                                                                 lo, hi):
    """cohort_clip_noise_prng on a rank's rows with ``row_offset``: bit
    for bit those rows of the whole launch, and its twin's."""
    from repro_torch import prng
    from repro_torch.analysis.salts import NOISE_SALT
    from repro_torch.kernels.cohort_dp import (cohort_clip_noise_prng,
                                               cohort_clip_noise_prng_ref,
                                               counter_normals)
    g = torch.Generator(device=dev).manual_seed(C)
    U = torch.randn((C, D), generator=g, device=dev)
    mask = torch.rand(C, generator=g, device=dev) < 0.6
    wts = 0.1 * mask.float()
    key = prng.fold_in(prng.PRNGKey(2 ^ NOISE_SALT), 9)
    kw = dict(clip=1.0, noise_scale=0.8, with_agg=False)
    whole, _ = cohort_clip_noise_prng(U, key, wts, mask, **kw)
    rows, _ = cohort_clip_noise_prng(U[lo:hi], key, wts[lo:hi], mask[lo:hi],
                                     row_offset=lo, **kw)
    assert _bits_equal(rows, whole[lo:hi])
    twin, _ = cohort_clip_noise_prng_ref(U[lo:hi], key, wts[lo:hi],
                                         mask[lo:hi], row_offset=lo, **kw)
    n = counter_normals(key, hi - lo, D, device=dev, start=lo * D)
    row_tol = ROW_RTOL * (U[lo:hi].abs() + 0.8 * n.abs())
    assert bool(((rows - twin).abs() <= row_tol).all())


@pytest.mark.parametrize("N,D,dtype", [
    (0, 13, torch.float32), (1, 1, torch.float32), (11, 13, torch.float32),
    (12, 785, torch.float32), (13, 785, torch.float32),
    (25, 785, torch.bfloat16), (3300, 785, torch.float32),
    (6600, 785, torch.bfloat16), (50, 1500, torch.float32),
    (50, 1500, torch.bfloat16), (6000, 785, torch.float32),
    (60000, 785, torch.float32), (60000, 785, torch.bfloat16)])
@pytest.mark.parametrize("layout", ["aligned", "offset"])
def test_clip_accumulate_matches_its_twin_bitwise(dev, N, D, dtype, layout):
    """The kernel against clip_accumulate_twin (its norm and column add
    order, on the CPU) bit for bit and against clip_accumulate_ref within
    SUM_RTOL; two launches bitwise; an all -0.0 column stays -0.0.  N
    60000 and 6000 at D 785: the DP round and its microbatch; D 1500: two
    column slabs (scales from the norm pass); "offset": a row view one
    row into a larger tensor (4-byte copies where D % 4 != 0)."""
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.dp_clip import (clip_accumulate,
                                             clip_accumulate_ref,
                                             clip_accumulate_twin)
    g = torch.Generator(device=dev).manual_seed(N + D)
    extra = 1 if layout == "offset" else 0
    G = (3.0 * torch.randn((N + extra, D), generator=g, device=dev)).to(
        dtype)[extra:]
    G[:, 0] = -0.0
    reset()
    k = clip_accumulate(G, clip=0.1)
    k2 = clip_accumulate(G, clip=0.1)
    torch.cuda.synchronize()
    assert LAUNCHES["clip_accumulate"] == 2
    assert k.dtype == torch.float32 and tuple(k.shape) == (D,)
    assert _bits_equal(k, k2)
    assert _bits_equal(k.cpu(), clip_accumulate_twin(G.cpu(), 0.1))
    p = clip_accumulate_ref(G, 0.1)
    tol = SUM_RTOL * clip_accumulate_ref(G.abs(), 0.1)
    assert bool(((k - p).abs() <= tol + 1e-30).all())
    if N:
        assert bool(torch.signbit(k[0]))


@pytest.mark.parametrize("kernel", ["tick_scatter", "clip_accumulate"])
def test_sum_limit_catches_a_dropped_block_partial(dev, kernel):
    """The planted fault chip_smoke.py must catch: the finish pass with
    one block's partial left out reads above SUM_RTOL * sum|terms| at the
    paths' shapes (C 16384, G 2; N 60000, D 785)."""
    import chip_smoke as cs
    if kernel == "tick_scatter":
        from repro_torch.kernels.tick_fused import tick_scatter_ref
        args = _scatter_case(dev, 16384, 785, 2, 0.5, "aligned", seed=7)
        ratio = cs.scatter_planted_drop(args, tick_scatter_ref(
            *args, dp_on=True)[2])
    else:
        from repro_torch.kernels.dp_clip import clip_accumulate_ref
        g = torch.Generator(device=dev).manual_seed(5)
        G = 3.0 * torch.randn((60000, 785), generator=g, device=dev)
        ratio = cs.clip_planted_drop(G, 0.1, clip_accumulate_ref(G, 0.1))
    assert ratio > 1.0


def _server_case(dev, D, kind, far, arr, fl, nf, *, offset=0, seed=0):
    """Engine-shaped operands of one server step on ``dev`` (``offset``
    floats past a 16-byte boundary), -0.0 planted in v, the due slot, the
    overflow rows and the buffer; returns (args, kwargs) for
    ``server_apply`` and the tensors it writes in place."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A = 4 if kind == "fedasync" else 1
    L, Q, B = 2, 2, 4

    def rn(*shape):
        t = torch.randn(int(np.prod(shape)) + offset, generator=g,
                        device=dev)
        return t[offset:].view(shape)

    v, ring, ovf = rn(D), rn(L, A, D), rn(Q, A, D)
    buf, bc = rn(D), rn(B, D)
    z = min(D, 12)
    v[:z:2] = -0.0
    ring[1, :, 1:z:3] = -0.0
    ovf[:, :, :z:3] = -0.0
    buf[2:z:2] = -0.0
    hit = torch.zeros(Q, dtype=torch.bool, device=dev)
    if far == "due":
        hit[1] = True
    fired = torch.zeros(B, dtype=torch.bool, device=dev)
    fired[1:1 + nf] = True
    dec = (torch.rand(A, generator=g, device=dev) + 0.1 if A > 1
           else torch.ones(1, device=dev))
    kw = dict(reset=True, ovf=ovf if far != "none" else None,
              ovf_hit=hit if far != "none" else None,
              buf=buf if kind == "fedbuff" else None,
              flush=torch.tensor(fl, device=dev),
              bc_v=bc if nf else None, fired=fired)
    args = (v, ring[1], dec, torch.tensor(arr, device=dev))
    return args, kw, dict(ring=ring, ovf=ovf, buf=buf, bc=bc)


def _server_cases():
    for kind in ("paper", "fedasync", "fedbuff"):
        for far in ("none", "due", "idle"):
            for arr in (True, False):
                for fl in ((True, False) if kind == "fedbuff" else (False,)):
                    for nf in (0, 1, 2):
                        yield kind, far, arr, fl, nf


@pytest.mark.parametrize("D,offset", [(1, 0), (37, 0), (785, 0), (1024, 0),
                                      (1024, 1), (4099, 2)])
def test_server_apply_matches_its_twin_bitwise(dev, D, offset):
    """Every case of ``tests/test_torch_server_apply.py``: the kernel's v'
    and every row it writes in place bit for bit the twin's, run on
    copies of the same operands; two launches give the same bits; one
    launch a call, counted under ``bucket_apply``."""
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.tick_fused import server_apply, server_apply_ref
    for n, case in enumerate(_server_cases()):
        outs = []
        for fn in (server_apply, server_apply, server_apply_ref):
            args, kw, inplace = _server_case(dev, D, *case, offset=offset,
                                             seed=D + n)
            reset()
            outs.append((fn(*args, **kw), *inplace.values()))
            assert LAUNCHES["bucket_apply"] == (fn is server_apply), case
        for k1, k2, p in zip(*outs):
            assert _bits_equal(k1, k2), case
            assert _bits_equal(k1, p), case


def test_server_apply_at_a_model_sized_D(dev):
    """The paper's step with a far tier entry due and one fired broadcast
    row at D = 2**28 + 3 (ragged: one column a thread, row offsets past
    2**31 bytes), against the twin bit for bit."""
    from repro_torch.kernels.tick_fused import server_apply, server_apply_ref
    D = (1 << 28) + 3
    case = ("paper", "due", True, False, 1)
    args, kw, inplace = _server_case(dev, D, *case, seed=7)
    twin = [t.clone() for t in (*args, *inplace.values())]
    out = server_apply(*args, **kw)
    v, due, dec, has_arr, ring, ovf, buf, bc = twin
    pkw = dict(kw, ovf=ovf, bc_v=bc, buf=None)
    ref = server_apply_ref(v, ring[1], dec, has_arr, **pkw)
    assert _bits_equal(out, ref)
    assert _bits_equal(inplace["ring"], ring)
    assert _bits_equal(inplace["ovf"], ovf)
    assert _bits_equal(inplace["bc"], bc)


def _logreg_block_case(dev, C, D, b, n_kind, seed):
    """Inputs of one block tick at C x D, b index columns: w and U with
    -0.0 planted, client 1's row all zero (z == 0 exactly: the balanced
    tie), ragged or uniform n."""
    g = torch.Generator(device=dev).manual_seed(seed)
    N = 3000
    X = torch.randn(N, D - 1, generator=g, device=dev)
    y = (torch.rand(N, generator=g, device=dev) > 0.5).float()
    w = 0.1 * torch.randn(C, D, generator=g, device=dev)
    U = 0.1 * torch.randn(C, D, generator=g, device=dev)
    w[:, 0], U[:, -1] = -0.0, -0.0
    if C > 1:
        w[1] = 0.0
    idx = torch.randint(0, N, (C, b), generator=g, device=dev)
    if n_kind == "ragged":
        n = torch.randint(0, b + 1, (C,), generator=g, device=dev,
                          dtype=torch.int32)
        n[:3] = torch.tensor([0, 1, b], dtype=torch.int32)[:C]
    else:
        n = torch.full((C,), {"zero": 0, "one": 1, "full": b}[n_kind],
                       dtype=torch.int32, device=dev)
    eta = 0.1 * torch.rand(C, generator=g, device=dev)
    return w, U, idx, n, eta, X, y


@pytest.mark.parametrize("C,D,b", [(4096, 785, 128), (130, 13, 40),
                                   (37, 1, 8), (64, 33, 40), (5, 801, 3),
                                   (6, 900, 3), (33, 131, 9)])
@pytest.mark.parametrize("n_kind", ["ragged", "zero", "one", "full"])
@pytest.mark.parametrize("clip,l2", [(0.0, 0.0), (0.1, 1.0 / 60000),
                                     (0.1, 0.0), (0.0, 0.01)])
def test_logreg_block_matches_its_twin(dev, C, D, b, n_kind, clip, l2):
    """``cohort_logreg_block`` against its plain twin on the same CUDA
    tensors, bit for bit, one launch; a client with n = 0 keeps its
    rows' bits."""
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.cohort_block import (logreg_block,
                                                  logreg_block_ref)
    args = _logreg_block_case(dev, C, D, b, n_kind, seed=C + D + b)
    reset()
    got = logreg_block(*args, l2=l2, clip=clip)
    torch.cuda.synchronize()
    assert LAUNCHES["cohort_logreg_block"] == 1
    want = logreg_block_ref(*args, l2=l2, clip=clip)
    w, U, _, n = args[:4]
    for k, p, old in zip(got, want, (w, U)):
        assert _bits_equal(k, p)
        idle = n == 0
        assert _bits_equal(k[idle], old[idle])


def test_logreg_block_rank_view_and_launch_record(dev):
    """A rank's row view of the task (``for_clients``) runs the kernel on
    its rows, bit for bit the whole population's block there and its
    twin; each launch is in the recorder's ``launches``."""
    from repro_torch.cohort.tasks import CohortLogRegTask
    from repro_torch.core import LogRegTask
    from repro_torch.kernels import LAUNCHES, reset
    from repro_torch.kernels.cohort_block import logreg_block_ref
    C, D, b = 4096, 785, 128
    X, y = (t.cpu() for t in _logreg_block_case(dev, 1, D, 1, "one",
                                                seed=3)[5:])
    task = LogRegTask(X, y, l2=1.0 / 60000, dp_clip=0.1, sample_seed=5)
    ct = CohortLogRegTask(task, C, device=dev)
    w, U, _, n, eta, _, _ = _logreg_block_case(dev, C, D, b, "ragged",
                                               seed=11)
    i = torch.randint(0, 40, (C,), device=dev, dtype=torch.int32)
    h = torch.randint(0, 60, (C,), device=dev, dtype=torch.int32)
    lo, hi = 1000, 3000
    view = ct.for_clients(lo, hi)
    view.spans = type("Rec", (), {"launches": []})()
    reset()
    whole = ct.run_block(w, U, i, h, n, eta, b)
    part = view.run_block(w[lo:hi], U[lo:hi], i[lo:hi], h[lo:hi], n[lo:hi],
                          eta[lo:hi], b)
    torch.cuda.synchronize()
    assert LAUNCHES["cohort_logreg_block"] == 2
    assert view.spans.launches == [("cohort_logreg_block", dict(
        C=hi - lo, D=D, b=b, clip=0.1, l2=1.0 / 60000))]
    twin = logreg_block_ref(w[lo:hi], U[lo:hi],
                            view.sample_idx(i[lo:hi], h[lo:hi], b), n[lo:hi],
                            eta[lo:hi], ct.X, ct.y, l2=1.0 / 60000, clip=0.1)
    for a, p, t in zip(whole, part, twin):
        assert _bits_equal(a[lo:hi], p)
        assert _bits_equal(p, t)


def test_logreg_block_refuses_more_features_than_it_holds(dev):
    from repro_torch.kernels.cohort_block import logreg_block
    from repro_torch.kernels.cohort_block.kernel import MAX_D
    args = _logreg_block_case(dev, 8, MAX_D + 2, 4, "full", seed=1)
    with pytest.raises(ValueError, match=f"at most {MAX_D} features"):
        logreg_block(*args, l2=0.0, clip=0.1)


@pytest.mark.parametrize("clip", [0.1, 1.0, 0.3, 3.7, 0.7, 1e-3, 2e-3,
                                  0.03, 0.013])
def test_card_divides_by_a_python_number_as_the_block_twin_does(dev, clip):
    """On the card PyTorch divides a tensor by a Python number as a
    product with the number's f32 reciprocal: the client block's clip
    step (``ref.clip_scale``, and the kernel) takes that product, the
    old eager block's and the benchmark reference's ``norm / clip``: the
    reciprocal taken in double and rounded to f32 (at 1e-3, 2e-3, 0.03
    and 0.013 the f32 reciprocal of the f32 clip is another number)."""
    from repro_torch.kernels.cohort_block.ref import clip_scale, inv_clip
    g = torch.Generator(device=dev).manual_seed(5)
    norm = 3 * torch.rand(1 << 16, generator=g, device=dev)
    assert _bits_equal(norm / clip, norm * inv_clip(clip))
    assert _bits_equal(clip_scale(norm, clip),
                       1.0 / torch.clamp(norm / clip, min=1.0))


@pytest.mark.parametrize("m", [128, 200, 784, 1000])
def test_lane_sum_is_torchs_row_sum_on_the_card(dev, m):
    """For a contiguous f32 row whose length is a multiple of 4 and at
    least 128, the client block's add order (``lane_sum``) is PyTorch's
    own row sum on the card, bit for bit."""
    from repro_torch.kernels.cohort_block import lane_sum
    g = torch.Generator(device=dev).manual_seed(m)
    v = torch.randn(4096, m, generator=g, device=dev) * 10.0 ** torch.randint(
        -4, 5, (4096, m), generator=g, device=dev)
    assert _bits_equal(lane_sum(v), v.sum(dim=-1))


@pytest.mark.parametrize("clip,l2", [(0.1, 1.0 / 60000), (0.0, 0.0)])
def test_logreg_block_is_the_old_eager_loop_at_d_784(dev, clip, l2):
    """At the cell's width the kernel gives the bits of the eager masked
    loop it replaced (torch's row sums, the clip as torch divides by a
    Python number), but for the sign of an exact zero."""
    from test_torch_cohort_block import masked_loop
    from repro_torch.cohort.tasks import CohortLogRegTask
    from repro_torch.core import LogRegTask
    from repro_torch.data import make_binary_dataset
    C, d, b = 4096, 784, 64
    X, y = make_binary_dataset(3000, d, seed=9, noise=0.3)
    ct = CohortLogRegTask(LogRegTask(X, y, l2=l2, dp_clip=clip,
                                     sample_seed=3), C, device=dev)
    w, U, _, n, eta, _, _ = _logreg_block_case(dev, C, d + 1, b, "ragged",
                                               seed=17)
    i = torch.randint(0, 40, (C,), device=dev, dtype=torch.int32)
    h = torch.randint(0, 60, (C,), device=dev, dtype=torch.int32)
    got = ct.run_block(w, U, i, h, n, eta, b)
    want = masked_loop(ct, w, U, n, eta, b, ct.sample_idx(i, h, b))
    for k, o in zip(got, want):
        assert torch.equal(k, o)          # == : +0.0 and -0.0 alike
