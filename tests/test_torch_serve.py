"""The port's serving path (repro_torch.launch.serve, repro_torch.data)
against the live reference (repro.launch.serve, repro.data), at
``reduced()`` size on the CPU: ``make_batch`` bit for bit; the greedy
tokens of ``prefill_into_cache`` + decode with the reference's weights
carried across, and of the two ``main``s as users start them; the entry
point refusing to run without CUDA unless asked for the CPU; and the
kernel wrappers the serving path reaches (``flash_attention``,
``ssd_scan``) raising where autograd would need a backward they lack,
while their plain versions differentiate.

Tolerances: tokens and batches are integers (equal); prefill logits
within the attention's 2e-5 abs + rel; gradients of the plain versions
within 2e-5 abs + rel of jax's.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.data as JD
import repro.models as JM
import repro_torch.configs as TC
import repro_torch.data as TD
import repro_torch.models as TM
from repro.kernels import flash_attention as jfa
from repro.launch import serve as jserve
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve as tserve

TOL = 2e-5


@pytest.mark.parametrize("arch", JC.ASSIGNED_ARCHS)
def test_make_batch_is_bitwise_the_reference(arch):
    jc, tc = JC.reduced(JC.get_config(arch)), TC.reduced(TC.get_config(arch))
    for B, S, kw in ((4, 32, {}), (3, 17, dict(seed=5, step=2, client_id=7))):
        want, got = JD.make_batch(jc, B, S, **kw), TD.make_batch(tc, B, S, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


def test_token_stream_and_encoder_stub_are_bitwise_the_reference():
    for V, seed in ((512, 0), (256000, 3), (51866, 11)):
        want = JD.TokenStream(V, seed=seed).batch(2, 50, step=4, client_id=9)
        got = TD.TokenStream(V, seed=seed).batch(2, 50, step=4, client_id=9)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(
        TD.encoder_embed_stub(2, 30, 64, seed=2, step=1),
        JD.encoder_embed_stub(2, 30, 64, seed=2, step=1))


def _greedy(serve_mod, models, cfg, params, cache, tokens, prompt_len, gen,
            to_int):
    """prefill_into_cache, then ``gen`` greedy decode steps: the
    prompt's last logits and the tokens."""
    seq_len = prompt_len + gen
    logits, cache = serve_mod.prefill_into_cache(cfg, params, cache, tokens,
                                                 seq_len=seq_len)
    last = logits[:, -1]
    out = []
    for i in range(gen):
        cur = to_int(logits[:, -1])
        out.append(np.asarray(cur))
        logits, cache = models.serve_step(cfg, params, cache, cur,
                                          prompt_len + i, seq_len=seq_len)
    out.append(np.asarray(to_int(logits[:, -1])))
    return last, np.concatenate(out, axis=1)


@pytest.mark.parametrize("arch", ["mamba2-780m", "gemma2-2b"])
def test_greedy_decode_gives_the_reference_tokens(arch):
    """Weights carried across: the same greedy tokens; the prompt's last
    logits equal the prefill pass's, which ties decode to prefill."""
    jc, tc = JC.reduced(JC.get_config(arch)), TC.reduced(TC.get_config(arch))
    P, G, B = 10, 6, 2
    jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    tp = convert.model_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                       device="cpu")
    batch = JD.make_batch(jc, B, P, seed=0)
    jt, tt = jnp.asarray(batch["tokens"]), torch.as_tensor(batch["tokens"])
    jlast, jtok = _greedy(
        jserve, JM, jc, jp, JM.init_cache(jc, B, P + G, jnp.float32), jt, P,
        G, lambda lg: jnp.argmax(lg, -1)[:, None].astype(jnp.int32))
    tlast, ttok = _greedy(
        tserve, TM, tc, tp,
        TM.init_cache(tc, B, P + G, torch.float32, device="cpu"), tt, P, G,
        lambda lg: torch.argmax(lg, -1)[:, None].to(torch.int32))
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=TOL,
                               atol=TOL)
    prefill = TM.forward_prefill(tc, tp, {"tokens": tt})
    np.testing.assert_allclose(tlast.numpy(), prefill.numpy(), rtol=TOL,
                               atol=TOL)


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("arch", ["mamba2-780m", "gemma2-2b"])
def test_serve_main_gives_the_reference_tokens(arch):
    """Both drivers with the reference's defaults but a shorter prompt and
    run, each drawing its own weights from seed 0 (the port's normals a
    few ulp off jax's): the same greedy sample."""
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "10", "--gen",
            "6"]
    want = _stdout(jserve.main, argv)
    got = _stdout(tserve.main, argv + ["--device", "cpu"])
    sample = [ln for ln in got.splitlines() if ln.startswith("sample:")]
    assert sample == [ln for ln in want.splitlines()
                      if ln.startswith("sample:")]
    assert len(sample) == 1 and "on cpu" in got


def test_serve_main_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--gen", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--gen", "1", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_params(TC.reduced(TC.get_config("gemma2-2b")),
                       torch.zeros(2, dtype=torch.int64), torch.float32)


# --- the kernels have no backward -------------------------------------------

def _qkv(requires_grad):
    rng = np.random.default_rng(0)
    return [torch.tensor(rng.standard_normal((1, 40, h, 16)).astype(np.float32),
                         requires_grad=requires_grad) for h in (4, 2, 2)]


def _ssd_args(requires_grad):
    rng = np.random.default_rng(1)
    shapes = {"x": (1, 40, 2, 8), "dt": (1, 40, 2), "A": (2,),
              "B": (1, 40, 4), "C": (1, 40, 4)}
    a = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    a["dt"] = np.log1p(np.exp(a["dt"])).astype(np.float32)
    a["A"] = -np.exp(0.1 * a["A"]).astype(np.float32)
    return [torch.tensor(a[k], requires_grad=requires_grad) for k in shapes]


def test_plain_attention_and_ssd_differentiate_as_jax():
    """On a CPU tensor the wrappers run their plain versions, which
    autograd differentiates: the gradients equal jax's."""
    q, k, v = _qkv(True)
    w = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (1, 40, 4, 16)).astype(np.float32))
    (fa_ops.attend(q, k, v, window=8, softcap=30.0) * w).sum().backward()
    jg = jax.grad(lambda *a: jnp.sum(jfa.attention_ref(
        *a, window=8, softcap=30.0) * w.numpy()), argnums=(0, 1, 2))(
        *(t.detach().numpy() for t in (q, k, v)))
    for t, g in zip((q, k, v), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=TOL,
                                   atol=TOL)
    args = _ssd_args(True)
    y, state = ssd_ops.ssd_scan(*args, 16)
    (y.sum() + state.sum()).backward()

    def jloss(*a):
        jy, js = jssm.ssd_chunked(*a, 16)
        return jnp.sum(jy) + jnp.sum(js)
    jg = jax.grad(jloss, argnums=tuple(range(5)))(
        *(t.detach().numpy() for t in args))
    for t, g in zip(args, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=TOL,
                                   atol=TOL)


def test_kernel_routes_raise_where_a_backward_is_needed(monkeypatch):
    """On the card (stood in for: ``on_cuda`` true, the kernel recorded)
    an input that requires grad raises in grad mode; under no_grad, or
    without such an input, the kernel is called."""
    calls = []
    monkeypatch.setattr(fa_ops, "on_cuda", lambda t: True)
    monkeypatch.setattr(ssd_ops, "on_cuda", lambda t: True)
    monkeypatch.setattr(fa_ops, "flash_attention_kernel",
                        lambda *a, **kw: calls.append("fa"))
    monkeypatch.setattr(ssd_ops, "ssd_scan_kernel",
                        lambda *a, **kw: calls.append("ssd"))
    with pytest.raises(RuntimeError, match="flash_attention kernel has no "
                                           "backward"):
        fa_ops.attend(*_qkv(True))
    with pytest.raises(RuntimeError, match="ssd_scan kernel has no backward"):
        ssd_ops.ssd_scan(*_ssd_args(True), 16)
    assert calls == []
    with torch.no_grad():
        fa_ops.attend(*_qkv(True))
        ssd_ops.ssd_scan(*_ssd_args(True), 16)
    fa_ops.attend(*_qkv(False))
    ssd_ops.ssd_scan(*_ssd_args(False), 16)
    assert calls == ["fa", "ssd", "fa", "ssd"]


def test_serving_path_loads_neither_jax_nor_the_reference():
    """The model API and the serve driver, run on the CPU in a fresh
    interpreter, import torch, numpy and the standard library only."""
    import os
    import subprocess
    import sys
    import textwrap
    code = textwrap.dedent("""
        import sys
        from repro_torch.launch import serve
        assert serve.main(["--arch", "hymba-1.5b", "--batch", "1",
                           "--prompt-len", "4", "--gen", "2",
                           "--device", "cpu"]) == 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "sample:" in out.stdout
