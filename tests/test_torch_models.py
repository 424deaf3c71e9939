"""The port's model API (repro_torch.models) against the live reference
(repro.models) at ``reduced()`` size (2 layers, d_model <= 256, vocab <=
512), for every assigned architecture: the params tree of
``init_params`` (structure, shapes, dtypes, f32 values), the prefill
logits and training loss, the decode cache and three ``serve_step``s,
with the reference's weights carried across
(``convert.model_params_from_jax``).  Then the port's twins of
``tests/test_models_smoke.py`` and ``tests/test_int8_kv.py``, and the
slab-drawn normal.  No test builds a full-width model.

Tolerances: initializers' normals within 5 f32 ulp of jax's (the port's
``normal`` is <= 3 ulp off: XLA's CPU ``log1p`` and FMAs in ``erf_inv``);
f32 logits, losses and caches within the attention's 2e-5 abs + rel
(measured: <= 2e-6 at these sizes; the layers reorder f32 sums); bf16
prefill logits within 5e-2 relative L2 per row (``BF16_ROW_REL_L2``).
The twins keep their reference tests' own tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models as JM
import repro_torch.configs as TC
import repro_torch.models as TM
from repro.data import make_batch
from repro.models import encdec as jencdec
from repro_torch import convert, prng, tree
from repro_torch.models import attention as tatt
from repro_torch.models import encdec as tencdec
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models.common import unembed

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 prefill logits, per row: ||port - ref||_2 / ||ref||_2.  Both
# frameworks round every bf16 op (eps 2^-8 = 3.9e-3) but not the same
# ones, compounded over two layers: measured 5.8e-3 (whisper) to 2.7e-2
# (qwen2-moe, whose expert sums add more bf16 roundings)
BF16_ROW_REL_L2 = 5e-2
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHS = JC.ASSIGNED_ARCHS


def _cfgs(arch, **kw):
    return (JC.reduced(JC.get_config(arch), **kw),
            TC.reduced(TC.get_config(arch), **kw))


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _flat(tree_, prefix=""):
    """{path: leaf} of a nested dict (jax's or the port's)."""
    if isinstance(tree_, dict):
        out = {}
        for k, v in tree_.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree_}


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _setup(arch, dtype="float32", B=2, S=24):
    """The reference's params and the port's copy of them, and a batch."""
    jc, tc = _cfgs(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(0), JDT[dtype])
    tp = convert.model_params_from_jax(_np(jp), device="cpu")
    b = make_batch(jc, B, S, seed=1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    return jc, tc, jp, tp, jb, tb


def _prime(jc, tc, jp, tp, jb, tb, jcache, tcache):
    """Both caches with the encoder's cross K/V for an encdec arch."""
    if jc.family != "encdec":
        return jcache, tcache
    jcache = jencdec.prime_cross_cache(
        jc, jp, jcache, jencdec.encode(jc, jp, jb["encoder_embeds"]))
    tcache = tencdec.prime_cross_cache(
        tc, tp, tcache, tencdec.encode(tc, tp, tb["encoder_embeds"]))
    return jcache, tcache


# --- the model API, every assigned arch ------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """Same leaves (paths), shapes and dtypes in f32 and bf16; f32 values
    within the normals' ulp bound, the bf16 ones within one bf16 ulp."""
    jc, tc = _cfgs(arch)
    for dt in ("float32", "bfloat16"):
        want = _flat(_np(JM.init_params(jc, jax.random.PRNGKey(3), JDT[dt])))
        got = _flat(TM.init_params(tc, prng.PRNGKey(3), TDT[dt],
                                   device="cpu"))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            g = got[path]
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype).split(".")[-1] == w.dtype.name, path
            w = w.astype(np.float32)
            if dt == "float32":
                ulp = np.spacing(np.abs(w))
                assert (np.abs(g.numpy() - w) <= 5 * ulp).all(), path
            else:
                ulp = np.spacing(np.abs(w).astype(jnp.bfloat16)
                                 ).astype(np.float32)
                assert (np.abs(_f32(g) - w) <= ulp).all(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_train_loss_match_reference(arch):
    jc, tc, jp, tp, jb, tb = _setup(arch)
    want = JM.forward_prefill(jc, jp, jb)
    got = TM.forward_prefill(tc, tp, tb)
    assert got.shape == (2, tc.vocab_size) and got.dtype == torch.float32
    _close(got, want, TOL["float32"])
    jl = float(JM.train_loss(jc, jp, jb))
    tl = TM.train_loss(tc, tp, tb)
    assert tl.shape == () and tl.dtype == torch.float32
    assert abs(float(tl) - jl) <= TOL["float32"] * (1 + abs(jl))
    # the plain cores named through the hooks are the CPU default's
    same = TM.forward_prefill(tc, tp, tb, attn_core=tatt.dense_attention,
                              ssd_fn=tssm.ssd_chunked)
    _close(same, want, TOL["float32"])


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-780m", "hymba-1.5b",
                                  "qwen2-moe-a2.7b", "whisper-large-v3"])
def test_bf16_prefill_matches_reference(arch):
    jc, tc, jp, tp, jb, tb = _setup(arch, "bfloat16")
    if "encoder_embeds" in jb:
        jb["encoder_embeds"] = jb["encoder_embeds"].astype(jnp.bfloat16)
        tb["encoder_embeds"] = tb["encoder_embeds"].to(torch.bfloat16)
    got = TM.forward_prefill(tc, tp, tb)
    want = _f32(JM.forward_prefill(jc, jp, jb))
    assert got.dtype == torch.float32
    d = _f32(got) - want
    rows = np.linalg.norm(d, axis=1) / np.linalg.norm(want, axis=1)
    assert rows.max() <= BF16_ROW_REL_L2, rows


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    jc, tc = _cfgs(arch)
    for dt in ("float32", "bfloat16"):
        want = _flat(_np(JM.init_cache(jc, 3, 20, JDT[dt])))
        got = _flat(TM.init_cache(tc, 3, 20, TDT[dt], device="cpu"))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            assert tuple(got[path].shape) == w.shape, path
            assert str(got[path].dtype).split(".")[-1] == w.dtype.name, path
            assert not got[path].float().abs().sum(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_three_serve_steps_match_reference(arch):
    """Logits and every cache leaf after each of three decode steps."""
    jc, tc, jp, tp, jb, tb = _setup(arch, S=8)
    seq_len = 8
    jcache = JM.init_cache(jc, 2, seq_len, jnp.float32)
    tcache = TM.init_cache(tc, 2, seq_len, torch.float32, device="cpu")
    jcache, tcache = _prime(jc, tc, jp, tp, jb, tb, jcache, tcache)
    for pos in range(3):
        jl, jcache = JM.serve_step(jc, jp, jcache,
                                   jb["tokens"][:, pos:pos + 1],
                                   jnp.int32(pos), seq_len=seq_len)
        tl, tcache = TM.serve_step(tc, tp, tcache,
                                   tb["tokens"][:, pos:pos + 1], pos,
                                   seq_len=seq_len)
        assert tl.shape == (2, 1, tc.vocab_size)
        _close(tl, jl, TOL["float32"])
        want, got = _flat(_np(jcache)), _flat(tcache)
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            _close(got[path], w, TOL["float32"])


def test_carried_cache_continues_the_reference_decode():
    """``convert.cache_from_jax``: the reference's cache after two steps,
    carried across, decodes the third step as the reference does."""
    jc, tc, jp, tp, jb, tb = _setup("hymba-1.5b", S=8)
    jcache = JM.init_cache(jc, 2, 8, jnp.float32)
    for pos in range(2):
        _, jcache = JM.serve_step(jc, jp, jcache, jb["tokens"][:, pos:pos + 1],
                                  jnp.int32(pos), seq_len=8)
    tcache = convert.cache_from_jax(_np(jcache), device="cpu")
    jl, _ = JM.serve_step(jc, jp, jcache, jb["tokens"][:, 2:3], jnp.int32(2),
                          seq_len=8)
    tl, _ = TM.serve_step(tc, tp, tcache, tb["tokens"][:, 2:3], 2, seq_len=8)
    _close(tl, jl, TOL["float32"])
    with pytest.raises(TypeError, match="dtype"):
        convert.model_params_from_jax({"w": np.zeros(3, np.float64)})


def test_chunked_local_pairs_match_reference(monkeypatch):
    """``REPRO_CHUNKED_LOCAL=1`` (read at call time): the (local, global)
    pair path, local layers block-local, against the reference's."""
    jc, tc = _cfgs("gemma2-2b")
    jc = dataclasses.replace(jc, sliding_window=16)
    tc = dataclasses.replace(tc, sliding_window=16)
    jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    tp = convert.model_params_from_jax(_np(jp), device="cpu")
    tokens = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 64),
                                               dtype=np.int32)
    monkeypatch.setenv("REPRO_CHUNKED_LOCAL", "1")
    jh, _ = JM.transformer.forward(jc, jp, jnp.asarray(tokens))
    th, _ = ttr.forward(tc, tp, torch.as_tensor(tokens))
    _close(th, jh, TOL["float32"])
    monkeypatch.delenv("REPRO_CHUNKED_LOCAL")
    full, _ = ttr.forward(tc, tp, torch.as_tensor(tokens))
    _close(th, full, 1e-4)     # exact math, other sums: the twin's 1e-4


@pytest.mark.parametrize("capacity", ["0.25", "1.25"])
def test_moe_routing_and_capacity_env_match_reference(monkeypatch, capacity):
    """``apply_moe`` under ``REPRO_MOE_CAPACITY`` (read at call time):
    output and aux loss, with a tie in the router planted (two equal
    expert columns: the lower index wins, as ``lax.top_k`` has it)."""
    from repro.models import moe as jmoe
    jc, tc = _cfgs("qwen2-moe-a2.7b")
    jlp = jax.tree_util.tree_map(lambda a: a[0], jmoe.init_moe(
        jc, jax.random.PRNGKey(0), jnp.float32))
    jlp["router"] = jlp["router"].at[:, 1].set(jlp["router"][:, 0])
    tlp = convert.model_params_from_jax(_np(jlp), device="cpu")
    x = np.random.default_rng(5).standard_normal(
        (2, 40, jc.d_model)).astype(np.float32)
    monkeypatch.setenv("REPRO_MOE_CAPACITY", capacity)
    jo, ja = jmoe.apply_moe(jc, jlp, jnp.asarray(x), group_size=16)
    to, ta = tmoe.apply_moe(tc, tlp, torch.as_tensor(x), group_size=16)
    _close(to, jo, TOL["float32"])
    _close(ta, ja, TOL["float32"])
    assert tmoe.group_capacity(16, 4, 2, float(capacity)) == \
        jmoe.group_capacity(16, 4, 2, float(capacity))
    assert tmoe.MOE_COMBINE_DTYPE == torch.float32


def test_top_k_breaks_ties_by_the_lower_index():
    x = np.array([[0.2, 0.5, 0.5, 0.1, 0.5], [1.0, 1.0, 1.0, 1.0, 0.0]],
                 np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = tmoe.top_k(torch.as_tensor(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# --- twins of tests/test_models_smoke.py -----------------------------------

def _port_model(arch, **replace):
    tc = TC.reduced(TC.get_config(arch))
    if replace:
        tc = dataclasses.replace(tc, **replace)
    return tc, TM.init_params(tc, prng.PRNGKey(0), torch.float32,
                              device="cpu")


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-780m", "hymba-1.5b",
                                  "qwen2-moe-a2.7b"])
def test_decode_matches_forward(arch):
    """Sequential decode logits == teacher-forced forward logits."""
    tc = TC.reduced(TC.get_config(arch))
    if tc.n_experts:
        # capacity dropping differs between the batch and step-wise paths;
        # the dense variant isolates the cache mechanics
        tc = dataclasses.replace(tc, n_experts=0, moe_top_k=0,
                                 n_shared_experts=0, d_ff=128)
    params = TM.init_params(tc, prng.PRNGKey(0), torch.float32, device="cpu")
    S = 12
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, tc.vocab_size, (1, S), dtype=np.int32))
    hidden, _ = ttr.forward(tc, params, tokens)
    full = unembed(tc, params, hidden)
    cache = TM.init_cache(tc, 1, S, torch.float32, device="cpu")
    outs = []
    for pos in range(S):
        lg, cache = TM.serve_step(tc, params, cache, tokens[:, pos:pos + 1],
                                  pos, seq_len=S)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-3)


def test_sliding_window_masked_vs_chunked():
    """attend_chunked (block-local) == attend_full with window mask."""
    tc = dataclasses.replace(TC.reduced(TC.get_config("gemma2-2b")),
                             sliding_window=32, local_global_period=None,
                             attn_softcap=None)
    lp = convert.layer(tatt.init_attention(tc, prng.PRNGKey(0),
                                           torch.float32, device="cpu"), 0)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 128, tc.d_model)).astype(np.float32))
    pos = torch.arange(128)[None].expand(2, 128)
    full = tatt.attend_full(tc, lp, x, pos, window=32)
    chunked = tatt.attend_chunked(tc, lp, x, pos, window=32)
    np.testing.assert_allclose(full.numpy(), chunked.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_ring_cache_decode_matches_full_cache():
    """Windowed ring decode == full cache decode with the same window."""
    tc, params = _port_model("gemma-2b", sliding_window=8)
    S = 24
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, tc.vocab_size, (1, S), dtype=np.int32))
    full = TM.init_cache(tc, 1, S, torch.float32, device="cpu")
    ring = TM.init_cache(tc, 1, 8, torch.float32, device="cpu")
    for pos in range(S):
        lf, full = TM.serve_step(tc, params, full, tokens[:, pos:pos + 1],
                                 pos, seq_len=S)
        lr, ring = TM.serve_step(tc, params, ring, tokens[:, pos:pos + 1],
                                 pos, seq_len=S)
        np.testing.assert_allclose(lr.numpy(), lf.numpy(), rtol=2e-3,
                                   atol=1e-4)


def test_ssd_decode_matches_chunked_scan():
    """Recurrent SSM decode == full-sequence SSD on the same inputs."""
    tc = TC.reduced(TC.get_config("mamba2-780m"))
    lp = convert.layer(tssm.init_ssm(tc, prng.PRNGKey(0), torch.float32,
                                     device="cpu"), 0)
    S = 16
    x = torch.as_tensor(0.5 * np.random.default_rng(1).standard_normal(
        (1, S, tc.d_model)).astype(np.float32))
    y_full = tssm.apply_ssm(tc, lp, x)
    d_inner, H, N, conv_dim, _ = tssm.ssm_dims(tc)
    h = torch.zeros((1, H, N, tc.ssm_head_dim))
    conv = torch.zeros((1, tc.ssm_conv_width - 1, conv_dim))
    outs = []
    for t in range(S):
        o, h, conv = tssm.decode_ssm(tc, lp, x[:, t:t + 1], h, conv)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y_full.numpy(),
                               rtol=5e-3, atol=5e-4)


def test_moe_capacity_drops_gracefully():
    tc = TC.reduced(TC.get_config("qwen2-moe-a2.7b"))
    lp = convert.layer(tmoe.init_moe(tc, prng.PRNGKey(0), torch.float32,
                                     device="cpu"), 0)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 32, tc.d_model)).astype(np.float32))
    out, aux = tmoe.apply_moe(tc, lp, x, capacity_factor=0.25)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    assert float(aux) > 0.0


def test_logit_softcap_bounds_logits():
    tc, params = _port_model("gemma2-2b")
    # blow up the embedding to force big logits
    params["embed"] = params["embed"] * 100.0
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    logits = TM.forward_prefill(tc, params, batch)
    assert float(logits.abs().max()) <= tc.logit_softcap + 1e-3


# --- twins of tests/test_int8_kv.py ------------------------------------------

def test_quantize_roundtrip_error_bounded():
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 8, 4, 64)).astype(np.float32))
    q, s = tatt.quantize_kv(x)
    x2 = tatt.dequantize_kv(q, s)
    rel = float((x2 - x).abs().max() / x.abs().max())
    assert rel < 1.0 / 100          # 7-bit mantissa => <1% absmax error
    assert q.dtype == torch.int8


def test_int8_decode_matches_f32_cache():
    tc, params = _port_model("gemma-2b")
    S = 12
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, tc.vocab_size, (1, S), dtype=np.int32))
    c_f = TM.init_cache(tc, 1, S, torch.float32, device="cpu")
    c_q = TM.init_cache(tc, 1, S, torch.int8, device="cpu")
    assert "k_scale" in c_q["kv"]
    for pos in range(S):
        lf, c_f = TM.serve_step(tc, params, c_f, toks[:, pos:pos + 1], pos,
                                seq_len=S)
        lq, c_q = TM.serve_step(tc, params, c_q, toks[:, pos:pos + 1], pos,
                                seq_len=S)
        np.testing.assert_allclose(torch.softmax(lq, -1).numpy(),
                                   torch.softmax(lf, -1).numpy(), atol=2e-3)


def test_int8_cache_halves_bytes():
    tc = TC.reduced(TC.get_config("gemma-2b"))

    def nbytes(c):
        return sum(t.numel() * t.element_size() for t in tree.leaves(c))

    c_f = TM.init_cache(tc, 2, 64, torch.bfloat16, device="cpu")
    c_q = TM.init_cache(tc, 2, 64, torch.int8, device="cpu")
    assert nbytes(c_q) < 0.65 * nbytes(c_f)


def test_int8_decode_matches_reference():
    """The quantized cache layout and three int8 decode steps against
    the reference's, weights carried across."""
    jc, tc, jp, tp, jb, tb = _setup("gemma-2b", S=8)
    jcache = JM.init_cache(jc, 2, 8, jnp.int8)
    tcache = TM.init_cache(tc, 2, 8, torch.int8, device="cpu")
    for pos in range(3):
        jl, jcache = JM.serve_step(jc, jp, jcache,
                                   jb["tokens"][:, pos:pos + 1],
                                   jnp.int32(pos), seq_len=8)
        tl, tcache = TM.serve_step(tc, tp, tcache,
                                   tb["tokens"][:, pos:pos + 1], pos,
                                   seq_len=8)
        _close(tl, jl, TOL["float32"])
    want, got = _flat(_np(jcache)), _flat(tcache)
    for path in ("/kv/k", "/kv/v"):
        # int8 values may round the other way where the f32 input sits
        # within the tolerance of a half step
        assert np.abs(got[path].numpy().astype(np.int32)
                      - want[path].astype(np.int32)).max() <= 1, path
    for path in ("/kv/k_scale", "/kv/v_scale"):
        _close(got[path], want[path], TOL["bfloat16"])


# --- the slab-drawn normal ----------------------------------------------------

@pytest.mark.parametrize("shape,slab", [((37, 29), 100), ((5, 7, 11), 7),
                                        ((1000,), 999), ((64, 33), 1 << 24)])
def test_slab_drawn_normal_equals_one_draw_bitwise(monkeypatch, shape,
                                                  slab):
    """``prng.normal`` drawn in slabs (their counters continuing the
    unsliced draw's) gives the bits of one draw, which are jax's within
    the normals' ulp bound."""
    key = prng.fold_in(prng.PRNGKey(11), 3)
    whole = prng._SQRT2_F32 * prng.erf_inv(
        prng.uniform(key, shape, prng._NORMAL_LO, 1.0))
    monkeypatch.setattr(prng, "NORMAL_SLAB", slab)
    got = prng.normal(key, shape)
    assert got.shape == whole.shape
    assert torch.equal(got.view(torch.int32), whole.view(torch.int32))
    want = np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(11), 3), shape))
    assert (np.abs(got.numpy() - want) <= 5 * np.spacing(np.abs(want))).all()


@pytest.mark.parametrize("arch", ["gemma2-2b", "hymba-1.5b", "gemma-2b"])
@pytest.mark.parametrize("seq_len", [8, 64, 5000])
def test_layer_windows_match_reference(arch, seq_len):
    """A global layer's window is the sequence length (the kernel reads
    ``window >= S`` as plain causal), a local one its sliding window."""
    for full in (True, False):
        jc, tc = ((JC.get_config(arch), TC.get_config(arch)) if full
                  else _cfgs(arch))
        assert ttr.layer_windows(tc, seq_len) == \
            np.asarray(JM.transformer.layer_windows(jc, seq_len)).tolist()


def test_bf16_rounding_model_at_depth_fits_the_chip_limits():
    """The limits ``chip_smoke.py`` phase 12 holds bf16 gemma2-2b to, end
    to end: a plain model of the bf16 kernel's rounding
    (``test_torch_attention._bf16_kernel_model``) as the attention core
    of gemma2-2b's 26 layers, at d_model 256 and S 512, against the
    reference's dense core.  The gap compounds with depth past phase 8's
    one-layer limits (about 2e-2 rel L2 here), and stays within phase
    12's with room."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from test_torch_attention import _bf16_kernel_model

    def kernel_model(q, k, v, *, causal, window, softcap):
        return _bf16_kernel_model(q, k, v, window=window, softcap=softcap)

    tc = dataclasses.replace(TC.get_config("gemma2-2b"), d_model=256,
                             n_heads=8, n_kv_heads=4, head_dim=64,
                             d_ff=1024, vocab_size=2048, sliding_window=128)
    params = TM.init_params(tc, prng.PRNGKey(0), torch.bfloat16,
                            device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, tc.vocab_size, (1, 512)))
    with torch.no_grad():
        got, _ = ttr.forward(tc, params, tokens, attn_core=kernel_model)
        want, _ = ttr.forward(tc, params, tokens,
                              attn_core=tatt.dense_attention)
    d = (got.float() - want.float()).reshape(-1, tc.d_model)
    w = want.float().reshape(-1, tc.d_model)
    whole = float(d.norm() / w.norm())
    row = float((d.norm(dim=1) / w.norm(dim=1)).max())
    assert whole > chip_smoke.ATTN_BF16_REL_L2     # past one layer's limit
    assert whole <= chip_smoke.MODEL_BF16_REL_L2 / 2, whole
    assert row <= chip_smoke.MODEL_BF16_ROW_REL_L2 / 2, row
