"""The port's Mamba-2 mixer against the live JAX reference: the
``ssd_scan`` ops (plain route on the CPU) against the reference's
``ops.ssd`` (Pallas, interpret mode) at the reference suite's shapes,
``ssd_chunked`` with its final state, each of its phases (the CUDA
kernels' phases: ``ssd_cb``, ``ssd_chunk_states``, ``ssd_state_passing``,
``ssd_chunk_outputs``), and every function of
``models/ssm.py`` at ``reduced(mamba2_780m)`` with the reference's
params carried across by ``repro_torch.convert``.

Tolerances: the reference suite's own for the SSD, max error over max
|ref| below 1e-5 (f32) and 3e-2 (bf16) (``tests/test_kernels.py``),
applied to the final state as well; the mixer's f32 outputs, which sum
d_inner products after a norm, within 2e-5 abs + rel, its bf16 outputs
(each op rounds to bf16, so an output near 0 may move by a few bf16 ulp
of the terms) within 3e-2 of max |ref|; a decode step against the
full-sequence mixer at the same position (recurrent against chunked
form) within 1e-4 rel + 1e-5 abs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_780m as jmamba
from repro.configs.base import reduced as jreduced
from repro.kernels import ssd_scan as jssd
from repro.models import ssm as jssm
from repro_torch import convert, prng
from repro_torch.configs import mamba2_780m as tmamba
from repro_torch.configs.base import reduced as treduced
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import ssm as tssm

SSD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got.astype(np.float32) - want).max()
                 / (np.abs(want).max() + 1e-9))


def _close(got, want, tol):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(0.1 * rng.standard_normal((h,)))).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, B, C


def _cfgs():
    return jreduced(jmamba.config()), treduced(tmamba.config())


def test_configs_are_copies():
    for jc, tc in ((jmamba.config(), tmamba.config()), _cfgs()):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tssm.ssm_dims(tc) == jssm.ssm_dims(jc)
        assert (tc.ssm_d_inner, tc.ssm_n_heads) == (jc.ssm_d_inner,
                                                    jc.ssm_n_heads)
    assert tmamba.config().source == "[arXiv:2405.21060]"


# --- the ssd_scan ops -----------------------------------------------------

@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 256, 4, 32, 16, 64),
    (1, 128, 2, 64, 32, 128),
    (2, 192, 3, 32, 64, 64),
    (1, 100, 2, 32, 16, 64),      # odd sequence: padded / masked
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_matches_reference_ops(b, s, h, p, n, chunk, dtype):
    x, dt, A, B, C = _ssd_inputs(0, b, s, h, p, n)
    want = jssd.ssd(jnp.asarray(x).astype(JDT[dtype]), *map(jnp.asarray,
                                                            (dt, A, B, C)),
                    chunk=chunk)
    got = tssd.ssd(torch.tensor(x).to(TDT[dtype]), *map(torch.tensor,
                                                        (dt, A, B, C)),
                   chunk=chunk)
    assert got.dtype == TDT[dtype]
    assert _rel(got, want) < SSD_TOL[dtype]


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("s,chunk", [(256, 64), (100, 64), (50, 128)])
def test_ssd_chunked_final_state_matches_reference(init, s, chunk):
    x, dt, A, B, C = _ssd_inputs(1, 2, s, 3, 32, 16)
    h0 = (np.random.default_rng(2).standard_normal((2, 3, 16, 32))
          .astype(np.float32) if init else None)
    jy, jf = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                              initial_state=None if h0 is None
                              else jnp.asarray(h0))
    ty, tf = tssm.ssd_chunked(*map(torch.tensor, (x, dt, A, B, C)), chunk,
                              None if h0 is None else torch.tensor(h0))
    ky, kf = tssd.ssd_scan(*map(torch.tensor, (x, dt, A, B, C)), chunk,
                           None if h0 is None else torch.tensor(h0))
    assert tf.shape == (2, 3, 16, 32) and tf.dtype == torch.float32
    for got in ((ty, tf), (ky, kf)):
        assert _rel(got[0], jy) < SSD_TOL["float32"]
        assert _rel(got[1], jf) < SSD_TOL["float32"]


# --- the plain SSD's phases (the kernels' phases) ---------------------------

PHASE_CASES = [
    pytest.param(2, 100, 3, 32, 16, 64, False, "float32", None,
                 id="ragged-s-p32"),
    pytest.param(1, 50, 2, 64, 12, 128, False, "float32", None,
                 id="s-below-chunk"),
    pytest.param(2, 192, 3, 64, 32, 64, True, "float32", None,
                 id="initial-state"),
    pytest.param(2, 130, 2, 32, 16, 64, True, "bfloat16", None, id="bf16"),
    pytest.param(1, 200, 2, 32, 16, 64, True, "float32", -8.0,
                 id="strong-decay"),
]


@pytest.mark.parametrize("phase", ["cb", "chunk_states", "state_passing",
                                   "chunk_outputs", "composition"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,init,dtype,a", PHASE_CASES)
def test_ssd_phases_match_reference(phase, b, s, h, p, n, chunk, init,
                                    dtype, a):
    """Each plain phase of ``ref.py`` (what each CUDA kernel computes)
    against the JAX reference: C B^T against the reference's own einsum
    on its padded chunks; dA_cum against its cumsum; each chunk's own
    state against ``ssd_chunked``'s final state of that chunk alone; the
    state before chunk c against its final state over the first c chunks;
    the outputs and the composition against its ``y`` (and the Pallas
    ``ops.ssd`` in interpret mode).  f32 intermediates within SSD_TOL's
    f32 limit of max |ref|, y within the dtype's."""
    x, dt, A, B, C = _ssd_inputs(6, b, s, h, p, n)
    if a is not None:
        A = np.full((h,), a, np.float32)
    h0 = (np.random.default_rng(7).standard_normal((b, h, n, p))
          .astype(np.float32) if init else None)
    jin = (jnp.asarray(x, JDT[dtype]), jnp.asarray(dt), jnp.asarray(A),
           jnp.asarray(B, JDT[dtype]), jnp.asarray(C, JDT[dtype]))
    tin = tuple(torch.tensor(np.asarray(t.astype(jnp.float32)))
                .to(TDT[dtype] if i in (0, 3, 4) else torch.float32)
                for i, t in enumerate(jin))
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else torch.tensor(h0)
    Q = min(chunk, s)
    nc = -(-s // Q)
    pad = nc * Q - s
    f32 = SSD_TOL["float32"]

    def jchunks(t):                                   # (b, s, ...) f32
        t = jnp.pad(t.astype(jnp.float32),
                    ((0, 0), (0, pad)) + ((0, 0),) * (t.ndim - 2))
        return t.reshape((b, nc, Q) + t.shape[2:])

    def jssd_prefix(t1, init=None):                   # the first t1 steps
        return jssm.ssd_chunked(jin[0][:, :t1], jin[1][:, :t1], jin[2],
                                jin[3][:, :t1], jin[4][:, :t1], chunk,
                                initial_state=init)

    xf, dtf, Af, Bc, Cc = tssd.ssd_chunks(*tin, chunk)
    cum, states = tssd.ssd_chunk_states(xf, dtf, Af, Bc)
    prev, final = tssd.ssd_state_passing(states, cum, th0)
    CB = tssd.ssd_cb(Cc, Bc)
    yc = tssd.ssd_chunk_outputs(xf, dtf, cum, Cc, CB, prev)
    jy, jf = jssd_prefix(s, jh0)
    if phase == "cb":
        want = jnp.einsum("bcin,bcjn->bcij", jchunks(jin[4]), jchunks(jin[3]))
        assert _rel(CB, want) < f32
    elif phase == "chunk_states":
        assert _rel(cum, jnp.cumsum(jchunks(jin[1]) * jin[2][None, None, None],
                                    axis=2)) < f32
        for c in range(nc):
            t0, t1 = c * Q, min(s, (c + 1) * Q)
            _, jst = jssm.ssd_chunked(jin[0][:, t0:t1], jin[1][:, t0:t1],
                                      jin[2], jin[3][:, t0:t1],
                                      jin[4][:, t0:t1], chunk)
            assert _rel(states[:, c], jst) < f32
    elif phase == "state_passing":
        start = torch.zeros_like(final) if th0 is None else th0
        assert torch.equal(prev[:, 0], start)
        for c in range(1, nc):
            assert _rel(prev[:, c], jssd_prefix(c * Q, jh0)[1]) < f32
        assert _rel(final, jf) < f32
    elif phase == "chunk_outputs":
        assert yc.dtype == torch.float32
        assert _rel(yc.reshape(b, nc * Q, h, p)[:, :s], jy) < SSD_TOL[dtype]
    else:
        ty, tf = tssd.ssd_chunked(*tin, chunk, th0)
        assert ty.dtype == TDT[dtype]
        assert _rel(ty, jy) < SSD_TOL[dtype] and _rel(tf, jf) < f32
        assert torch.equal(ty, (yc.reshape(b, nc * Q, h, p)[:, :s]
                                .to(TDT[dtype])))
        if h0 is None:      # the Pallas ops take no initial state
            want = jssd.ssd(jin[0], *(t.astype(jnp.float32)
                                      for t in jin[1:]), chunk=chunk)
            assert _rel(ty, want) < SSD_TOL[dtype]


# --- models/ssm.py --------------------------------------------------------

def _layer(dtype="float32", seed=0):
    jc, tc = _cfgs()
    jp = jssm.init_ssm(jc, jax.random.PRNGKey(seed), JDT[dtype])
    # the reference initialises the biases to 0 and A_log to 0: make the
    # per-head terms count
    rng = np.random.default_rng(seed)
    jp = dict(jp)
    for k in ("conv_b", "dt_bias", "A_log", "D", "gate_norm"):
        jp[k] = jnp.asarray(0.3 * rng.standard_normal(jp[k].shape)
                            + (1.0 if k in ("D", "gate_norm") else 0.0),
                            JDT[dtype])
    tp = convert.stacked_params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()})
    return jc, tc, {k: v[1] for k, v in jp.items()}, convert.layer(tp, 1)


def test_init_ssm_and_state_match_reference():
    jc, tc = _cfgs()
    jp = jssm.init_ssm(jc, jax.random.PRNGKey(7), jnp.float32)
    tp = tssm.init_ssm(tc, prng.PRNGKey(7), torch.float32, device="cpu")
    assert sorted(jp) == sorted(tp)
    for k in jp:
        want = np.asarray(jp[k])
        assert tuple(tp[k].shape) == want.shape
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(tp[k].numpy() - want) <= 5 * ulp).all(), k
    js = jssm.init_ssm_state(jc, 3)
    ts = tssm.init_ssm_state(tc, 3, device="cpu")
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape and not ts[k].any()
    assert tssm.init_ssm(tc, prng.PRNGKey(7), torch.float32, n_layers=1,
                         device="cpu")["in_proj"].shape[0] == 1


def test_causal_depthwise_conv_and_split_match_reference():
    jc, tc, jl, tl = _layer()
    rng = np.random.default_rng(3)
    conv_dim = tssm.ssm_dims(tc)[3]
    x = rng.standard_normal((2, 21, conv_dim)).astype(np.float32)
    _close(tssm.causal_depthwise_conv(torch.tensor(x), tl["conv_w"],
                                      tl["conv_b"]),
           jssm.causal_depthwise_conv(jnp.asarray(x), jl["conv_w"],
                                      jl["conv_b"]), 1e-6)
    proj = rng.standard_normal((2, 5, tssm.ssm_dims(tc)[4])).astype(
        np.float32)
    for a, b in zip(tssm._split_proj(tc, torch.tensor(proj)),
                    jssm._split_proj(jc, jnp.asarray(proj))):
        if torch.is_tensor(a):
            assert (a.numpy() == np.asarray(b)).all()
        else:
            assert a == b


@pytest.mark.parametrize("ssd", ["kernel", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_ssm_matches_reference(ssd, dtype):
    """The mixer through the kernel's route (the default ``ssd_fn``) and
    through the plain chunked SSD, S = 70 (not a chunk multiple), with
    the final state and the conv state."""
    jc, tc, jl, tl = _layer(dtype)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 70, jc.d_model)).astype(np.float32)
    jo, jf, jcv = jssm.apply_ssm(jc, jl, jnp.asarray(x, JDT[dtype]),
                                 return_state=True)
    kw = {} if ssd == "kernel" else {"ssd_fn": tssm.ssd_chunked}
    to, tf, tcv = tssm.apply_ssm(tc, tl, torch.tensor(x).to(TDT[dtype]),
                                 return_state=True, **kw)
    assert to.dtype == TDT[dtype]
    if dtype == "float32":
        _close(to, jo, TOL[dtype])
    else:   # a value near 0 after bf16 roundings: relative to max |ref|
        assert _rel(to, jo) < SSD_TOL[dtype]
    assert _rel(tf, jf) < SSD_TOL[dtype]
    _close(tcv, jcv, TOL[dtype])
    out_only = tssm.apply_ssm(tc, tl, torch.tensor(x).to(TDT[dtype]), **kw)
    assert torch.equal(out_only, to)


def test_decode_ssm_matches_reference_and_continues_the_prefill():
    """Three recurrent steps from the prefill's state: each against the
    reference's step from the same state, and the steps' outputs against
    the full-sequence mixer over the longer sequence."""
    jc, tc, jl, tl = _layer()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40 + 3, jc.d_model)).astype(np.float32)
    _, jh, jconv = jssm.apply_ssm(jc, jl, jnp.asarray(x[:, :40]),
                                  return_state=True)
    _, th, tconv = tssm.apply_ssm(tc, tl, torch.tensor(x[:, :40]),
                                  return_state=True)
    full = tssm.apply_ssm(tc, tl, torch.tensor(x))
    th, tconv = th, tconv.to(torch.float32)
    jconv = jconv.astype(jnp.float32)
    for t in range(40, 43):
        xt = x[:, t:t + 1]
        jo, jh, jconv = jssm.decode_ssm(jc, jl, jnp.asarray(xt), jh, jconv)
        to, th, tconv = tssm.decode_ssm(tc, tl, torch.tensor(xt), th, tconv)
        _close(to, jo, TOL["float32"])
        assert _rel(th, jh) < SSD_TOL["float32"]
        _close(tconv, jconv, TOL["float32"])
        np.testing.assert_allclose(to.numpy(), full[:, t:t + 1].numpy(),
                                   rtol=1e-4, atol=1e-5)
