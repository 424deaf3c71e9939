"""The port's attention path against the live JAX reference: the
``flash_attention`` ops (plain route on the CPU) against the reference's
``ops.attend`` (Pallas, interpret mode) at the reference suite's shapes,
and every function of ``models/common.py`` and ``models/attention.py``
at ``reduced(gemma2_2b)`` with the reference's params carried across by
``repro_torch.convert``.

Tolerances: the reference suite's own for attention, 2e-5 (f32) and
2e-2 (bf16) abs + rel (``tests/test_kernels.py``); elementwise functions
within a few f32 ulp (rtol 1e-6); layer outputs, which sum d_model
products, within 2e-5 (f32) and 2e-2 (bf16) abs + rel; initializers'
normals within 4 ulp of jax's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as jgemma
from repro.configs.base import reduced as jreduced
from repro.kernels import flash_attention as jfa
from repro.models import attention as jatt
from repro.models import common as jcom
from repro_torch import convert, prng
from repro_torch.configs import gemma2_2b as tgemma
from repro_torch.configs.base import reduced as treduced
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tatt
from repro_torch.models import common as tcom

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, tol):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _qkv(seed, B, S, H, KV, hd, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal((B, S, h, hd))).astype(np.float32)
            for h in (H, KV, KV)]


def _cfgs():
    return jreduced(jgemma.config()), treduced(tgemma.config())


def test_configs_are_copies():
    for full in (False, True):
        jc, tc = ((jgemma.config(), tgemma.config()) if full else _cfgs())
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.source == "[arXiv:2408.00118]"
        assert [tc.layer_is_local(i) for i in range(4)] == \
            [jc.layer_is_local(i) for i in range(4)]
    assert tgemma.config().param_count() == jgemma.config().param_count()


# --- the flash attention ops ----------------------------------------------

@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 256, 4, 2, 64),
    (1, 128, 2, 1, 128),     # MQA
    (2, 384, 8, 8, 32),      # MHA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_matches_reference_ops(B, S, H, KV, hd, dtype):
    q, k, v = _qkv(0, B, S, H, KV, hd)
    want = jfa.attend(*(jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, v)),
                      q_block=128, kv_block=128)
    got = tfa.attend(*(torch.tensor(a).to(TDT[dtype]) for a in (q, k, v)))
    assert got.dtype == TDT[dtype]
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("kw", [{"window": 64}, {"window": 128},
                                {"softcap": 30.0}, {}],
                         ids=["window64", "window128", "softcap", "odd_S"])
def test_attend_window_softcap_odd_S_match_reference_ops(kw):
    S = 200 if not kw else (128 if "softcap" in kw else 256)
    q, k, v = _qkv(1, 1, S, 4, 2, 64, 3.0 if "softcap" in kw else 1.0)
    want = jfa.attend(*map(jnp.asarray, (q, k, v)), **kw)
    got = tfa.attend(*map(torch.tensor, (q, k, v)), **kw)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_causal_odd_S_matches_attention_ref(dtype):
    """Non-causal attention over a sequence that is not a block multiple:
    the port matches ``attention_ref``.  The reference's padded ``attend``
    is not the target here: it lets its zero-padded keys into the softmax
    (ROADMAP.md Queue 3, flash_attention/ops.py:30-35)."""
    q, k, v = _qkv(2, 1, 200, 2, 2, 64)
    jq = [jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, v)]
    want = jfa.attention_ref(*jq, causal=False)
    got = tfa.attend(*(torch.tensor(a).to(TDT[dtype]) for a in (q, k, v)),
                     causal=False)
    _close(got, want, TOL[dtype])


def _bf16_kernel_model(q, k, v, *, window, softcap, kv_block=64):
    """Plain-torch model of the rounding of the bf16 tensor-core kernel
    (``csrc/flash_attention.cu``, ``tc::fa_bf16_kernel``): f32 scores of
    the bf16 operands, scaled after the product; the online softmax over
    64-key tiles in f32; p rounded to bf16 before P V (f32 accumulation),
    the row sum l taken from the f32 p; the output, O * (1/l), rounded to
    bf16."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, hd)
    kf, vf = k.float(), v.float()
    scale = 1.0 / np.sqrt(hd)
    m = torch.full((B, KV, H // KV, S), -1e30)
    l = torch.zeros((B, KV, H // KV, S))
    acc = torch.zeros((B, KV, H // KV, S, hd))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, kv_block):
        kt, vt = kf[:, k0:k0 + kv_block], vf[:, k0:k0 + kv_block]
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kt)
        if softcap is not None:
            s = softcap * torch.tanh(s * np.float32(scale / softcap))
        else:
            s = s * np.float32(scale)
        cols = torch.arange(k0, k0 + kt.shape[1])[None, :]
        mask = cols <= rows
        if window is not None:
            mask = mask & (rows - cols < window)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p.to(torch.bfloat16).float(), vt)
        m = m_new
    o = acc * (1.0 / l.clamp_min(1e-30))[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(torch.bfloat16)


@pytest.mark.parametrize("window", [None, 300], ids=["global", "window300"])
@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_bf16_kernel_rounding_fits_the_bf16_budget(window, scale):
    """The bf16 kernel's only new rounding (p in bf16 before P V) keeps it
    within the reference suite's bf16 tolerance of the reference's
    ``attention_ref`` at gemma2's head_dim 256 with softcap 50, causal,
    global and windowed: the design fits the budget before any card runs
    it."""
    q, k, v = _qkv(11, 1, 1024, 2, 1, 256, scale)
    jq = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = jfa.attention_ref(*jq, window=window, softcap=50.0)
    got = _bf16_kernel_model(*(torch.tensor(a).to(torch.bfloat16)
                               for a in (q, k, v)),
                             window=window, softcap=50.0)
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL["bfloat16"])


# chip_smoke.py's bf16 limits beside ATTN_TOL: ||out - ref|| / ||ref||
# whole and in the worst output row
REL_L2, ROW_REL_L2 = 5e-3, 2e-2


def _rel_l2(got, want):
    d = got.reshape(-1, got.shape[-1]) - want.reshape(-1, want.shape[-1])
    r = want.reshape(-1, want.shape[-1])
    rows = np.linalg.norm(d, axis=1) / np.linalg.norm(r, axis=1)
    return np.linalg.norm(d) / np.linalg.norm(r), rows.max()


@pytest.mark.parametrize("window", [None, 300], ids=["global", "window300"])
@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_bf16_kernel_rounding_fits_the_rel_l2_limits(window, scale):
    """The bf16 kernel's rounding model stays within chip_smoke.py's rel
    L2 limits of the reference's ``attention_ref`` (the limits that hold
    the kernel where ATTN_TOL's 2e-2 abs exceeds most outputs), and a
    planted fault, the last 128-row q tile attending without the 64 keys
    at S/2, reads far above the worst-row limit."""
    q, k, v = _qkv(11, 1, 1024, 2, 1, 256, scale)
    jq = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jfa.attention_ref(*jq, window=window, softcap=50.0),
                      np.float32)
    got = _bf16_kernel_model(*(torch.tensor(a).to(torch.bfloat16)
                               for a in (q, k, v)),
                             window=window, softcap=50.0).float().numpy()
    whole, row = _rel_l2(got, want)
    assert whole <= REL_L2 and row <= ROW_REL_L2, (whole, row)
    if window is None:
        # cutting the 64 positions out is exact for causal attention
        # without a window
        cut = [jnp.concatenate([a[:, :512], a[:, 576:]], axis=1) for a in jq]
        dropped = np.asarray(jfa.attention_ref(*cut, softcap=50.0),
                             np.float32)
        got[:, -128:] = dropped[:, -128:]
        assert _rel_l2(got, want)[1] > 5 * ROW_REL_L2


# --- models/common.py -----------------------------------------------------

def test_common_norms_and_activations():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    sc = rng.standard_normal((16,)).astype(np.float32)
    bi = rng.standard_normal((16,)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    assert tcom.expand_rank(torch.tensor(sc), 3).shape == \
        jcom.expand_rank(jnp.asarray(sc), 3).shape
    for gs in (False, True):
        _close(tcom.rms_norm(tx, torch.tensor(sc), 1e-6, gemma_style=gs),
               jcom.rms_norm(jx, jnp.asarray(sc), 1e-6, gemma_style=gs), 1e-6)
    _close(tcom.layer_norm(tx, torch.tensor(sc), torch.tensor(bi)),
           jcom.layer_norm(jx, jnp.asarray(sc), jnp.asarray(bi)), 1e-6)
    for norm in ("rmsnorm", "layernorm"):
        jc, tc = (dataclasses.replace(c, norm=norm) for c in _cfgs())
        jp = jcom.init_norm(jc, None, 16, jnp.float32)
        tp = tcom.init_norm(tc, None, 16, torch.float32, device="cpu")
        assert sorted(jp) == sorted(tp)
        for k in jp:
            assert (np.asarray(jp[k]) == tp[k].numpy()).all()
        jp = {k: jnp.asarray(sc) for k in jp}
        tp = {k: torch.tensor(sc) for k in tp}
        _close(tcom.apply_norm(tc, tx, tp), jcom.apply_norm(jc, jx, jp), 1e-6)
    _close(tcom.softcap(tx * 30, 50.0), jcom.softcap(jx * 30, 50.0), 1e-6)
    assert tcom.softcap(tx, None) is tx
    for kind in ("geglu", "silu"):
        _close(tcom.gated_act(kind, tx, tx + 1), jcom.gated_act(kind, jx,
                                                                jx + 1), 1e-6)
    with pytest.raises(ValueError):
        tcom.gated_act("relu", tx, tx)


def test_common_rope_and_positions():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) * 37, (2, 9)).astype(np.int32)
    _close(tcom.rope_frequencies(32, 10_000.0),
           jcom.rope_frequencies(32, 10_000.0), 1e-6)
    _close(tcom.apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0),
           jcom.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), 1e-5)
    tx = torch.tensor(x)
    assert tcom.apply_rope(tx, torch.tensor(pos), 0.0) is tx
    _close(tcom.sinusoidal_positions(40, 16),
           jcom.sinusoidal_positions(40, 16), 1e-5)


def test_common_embeddings_and_loss():
    jc, tc = (dataclasses.replace(c, vocab_size=300) for c in _cfgs())
    Vp = jcom.padded_vocab(300)
    assert tcom.padded_vocab(300) == Vp == 512
    assert tcom.padded_vocab(50280) == jcom.padded_vocab(50280)
    rng = np.random.default_rng(5)
    table = rng.standard_normal((Vp, jc.d_model)).astype(np.float32)
    toks = rng.integers(0, 300, (2, 7)).astype(np.int32)
    jx = jcom.embed_tokens(jc, {"embed": jnp.asarray(table)},
                           jnp.asarray(toks))
    tx = tcom.embed_tokens(tc, {"embed": torch.tensor(table)},
                           torch.tensor(toks, dtype=torch.int64))
    _close(tx, jx, 1e-6)
    jl = jcom.unembed(jc, {"embed": jnp.asarray(table)}, jx)
    tl = tcom.unembed(tc, {"embed": torch.tensor(table)}, tx)
    _close(tl, jl, 2e-5)
    labels = rng.integers(0, 300, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = jcom.cross_entropy_loss(jl, jnp.asarray(labels),
                                       None if m is None else jnp.asarray(m))
        got = tcom.cross_entropy_loss(
            tl, torch.tensor(labels), None if m is None else torch.tensor(m))
        _close(got, want, 2e-5)


# --- models/attention.py --------------------------------------------------

def _layer(dtype="float32", seed=0, bias=False):
    jc, tc = _cfgs()
    if bias:
        jc, tc = (dataclasses.replace(c, qkv_bias=True) for c in (jc, tc))
    jp = jatt.init_attention(jc, jax.random.PRNGKey(seed), JDT[dtype])
    if bias:   # the reference initialises biases to 0: make them count
        rng = np.random.default_rng(seed)
        jp = {k: (jnp.asarray(rng.standard_normal(v.shape), JDT[dtype])
                  if k.startswith("b") else v) for k, v in jp.items()}
    tp = convert.stacked_params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()})
    return jc, tc, {k: v[1] for k, v in jp.items()}, convert.layer(tp, 1)


def test_init_attention_matches_reference():
    jc, tc = _cfgs()
    jp = jatt.init_attention(jc, jax.random.PRNGKey(7), jnp.float32)
    tp = tatt.init_attention(tc, prng.PRNGKey(7), torch.float32, device="cpu")
    assert sorted(jp) == sorted(tp)
    for k in jp:
        want = np.asarray(jp[k])
        assert tp[k].shape == want.shape
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(tp[k].numpy() - want) <= 5 * ulp).all(), k
    jb = jatt.init_attention(jc, jax.random.PRNGKey(7), jnp.bfloat16)
    tb = tatt.init_attention(tc, prng.PRNGKey(7), torch.bfloat16,
                             device="cpu")
    # bf16 rounding of normals within 4 f32 ulp: at most one bf16 ulp apart
    d = np.abs(tb["wq"].float().numpy() - np.asarray(jb["wq"], np.float32))
    assert (d <= np.abs(np.asarray(jb["wq"], np.float32)) * 2 ** -7).all()


def test_convert_carries_bf16_leaves_exactly():
    jc, tc, jl, tl = _layer("bfloat16")
    assert tl["wq"].dtype == torch.bfloat16
    assert (tl["wq"].float().numpy()
            == np.asarray(jl["wq"], np.float32)).all()
    with pytest.raises(ValueError, match="depths"):
        convert.stacked_params_from_jax({"a": np.zeros((2, 3), np.float32),
                                         "b": np.zeros((3, 3), np.float32)})


def test_causal_mask_bitwise():
    for Sq, Sk, w in ((5, 5, None), (1, 9, 4), (7, 12, 3)):
        assert (tatt.causal_mask(Sq, Sk, w).numpy()
                == np.asarray(jatt.causal_mask(Sq, Sk, w))).all()


@pytest.mark.parametrize("bias", [False, True])
def test_project_qkv_matches_reference(bias):
    jc, tc, jl, tl = _layer(bias=bias)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 11, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11)).astype(np.int32)
    want = jatt._project_qkv(jc, jl, jnp.asarray(x), jnp.asarray(pos))
    got = tatt._project_qkv(tc, tl, torch.tensor(x), torch.tensor(pos))
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        _close(a, b, 2e-5)


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("core", ["kernel", "dense"])
def test_attend_full_matches_reference(window, dtype, core):
    """``attend_full`` through the kernel's route and through the dense
    core, against the reference's ``attend_full`` with a 32-query chunk
    (its q-chunk scan runs, S = 80 is not a chunk multiple)."""
    jc, tc, jl, tl = _layer(dtype)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 80, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(80), (2, 80)).astype(np.int32)
    want = jatt.attend_full(jc, jl, jnp.asarray(x, JDT[dtype]),
                            jnp.asarray(pos), window, q_chunk=32)
    kw = {} if core == "kernel" else {
        "core": lambda *a, **k: tatt.dense_attention(*a, q_chunk=32, **k)}
    got = tatt.attend_full(tc, tl, torch.tensor(x).to(TDT[dtype]),
                           torch.tensor(pos), window, **kw)
    assert got.dtype == TDT[dtype]
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("S", [64, 80])
def test_attend_chunked_matches_reference(S):
    """S = 64 runs the block-local path (window 16 divides it); S = 80
    with window 24 falls back to attend_full in both."""
    jc, tc, jl, tl = _layer()
    W = 16 if S == 64 else 24
    rng = np.random.default_rng(10)
    x = rng.standard_normal((1, S, jc.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    want = jatt.attend_chunked(jc, jl, jnp.asarray(x), jnp.asarray(pos), W)
    got = tatt.attend_chunked(tc, tl, torch.tensor(x), torch.tensor(pos), W)
    _close(got, want, TOL["float32"])


def test_kv_cache_layouts_and_quantization():
    jc, tc = _cfgs()
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.int8, torch.int8)):
        jcache = jatt.init_kv_cache(jc, 2, 10, dt)
        tcache = tatt.init_kv_cache(tc, 2, 10, tdt, device="cpu")
        assert sorted(jcache) == sorted(tcache)
        for k in jcache:
            assert tuple(tcache[k].shape) == jcache[k].shape
            assert str(tcache[k].dtype).split(".")[-1] == \
                str(jcache[k].dtype)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 4, 32)) * 2).astype(np.float32)
    jq, js = jatt.quantize_kv(jnp.asarray(x))
    tq, ts = tatt.quantize_kv(torch.tensor(x))
    assert (tq.numpy() == np.asarray(jq)).all()
    assert (ts.float().numpy() == np.asarray(js, np.float32)).all()
    _close(tatt.dequantize_kv(tq, ts), jatt.dequantize_kv(jq, js), 1e-7)


@pytest.mark.parametrize("ring,window,pos", [(False, None, 5),
                                             (False, 4, 9),
                                             (True, 6, 13),
                                             (True, None, 3)])
def test_decode_attend_matches_reference(ring, window, pos):
    jc, tc, jl, tl = _layer()
    rng = np.random.default_rng(12)
    L = 8
    ck = rng.standard_normal((2, L, jc.n_kv_heads, jc.head_dim)
                             ).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    want = jatt.decode_attend(jc, jl, jnp.asarray(x), jnp.asarray(ck),
                              jnp.asarray(cv), jnp.int32(pos), window,
                              ring=ring)
    got = tatt.decode_attend(tc, tl, torch.tensor(x), torch.tensor(ck),
                             torch.tensor(cv), pos, window, ring=ring)
    for a, b in zip(got, want):
        _close(a, b, TOL["float32"])
    # the quantized cache, written at the same slot
    jcache = {k: v[0] for k, v in jatt.init_kv_cache(jc, 2, L,
                                                     jnp.int8).items()}
    jcache["k"], jcache["k_scale"] = jatt.quantize_kv(jnp.asarray(ck))
    jcache["v"], jcache["v_scale"] = jatt.quantize_kv(jnp.asarray(cv))
    tcache = {k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.bfloat16 if "scale" in k else torch.int8)
        for k, v in jcache.items()}
    wq, wc = jatt.decode_attend_quantized(jc, jl, jnp.asarray(x), jcache,
                                          jnp.int32(pos), window, ring=ring)
    gq, gc = tatt.decode_attend_quantized(tc, tl, torch.tensor(x), tcache,
                                          pos, window, ring=ring)
    _close(gq, wq, TOL["float32"])
    for k in wc:
        assert (gc[k].float().numpy() == np.asarray(wc[k], np.float32)).all()


@pytest.mark.parametrize("bias", [False, True])
def test_cross_attention_matches_reference(bias):
    jc, tc, jl, tl = _layer(bias=bias)
    rng = np.random.default_rng(13)
    enc = rng.standard_normal((2, 19, jc.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 6, jc.d_model)).astype(np.float32)
    jk, jv = jatt.project_cross_kv(jc, jl, jnp.asarray(enc))
    tk, tv = tatt.project_cross_kv(tc, tl, torch.tensor(enc))
    _close(tk, jk, 2e-5)
    _close(tv, jv, 2e-5)
    want = jatt.cross_attend(jc, jl, jnp.asarray(x), jk, jv)
    got = tatt.cross_attend(tc, tl, torch.tensor(x), tk, tv)
    _close(got, want, TOL["float32"])
