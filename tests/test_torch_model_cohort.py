"""The model-scale cohort path of the port against the live reference:
the flat-params adapter (``repro_torch.cohort.flat``) and the three
engines driving a ``BatchModelTask`` through it (the batchers,
``prng.permutation`` and the masks are in ``test_torch_model_data.py``).

Twins of ``tests/test_cohort_model_parity.py`` on its tiny transformer
(1 layer, d_model 32, vocab 64; the reference's weights carried across
by ``convert.model_params_from_jax``), each also checked against the
reference's own run of the same configuration.  Tolerances: integers
(rounds, messages, broadcasts) exact; eval losses within 5e-6 and models
within 1e-5 of the reference's run, the reference test's own limits for
event vs cohort (measured here: <= 2e-7); the port's host and device
engines bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cohort as JCo
import repro.configs as JC
import repro.core as JCore
import repro.data as JD
from repro.models import init_params as j_init_params
from repro_torch import convert, tree
from repro_torch.cohort import (CohortBatchModelTask, CohortSimulator,
                                DeviceCohortSimulator, PyTreeFlattener,
                                as_cohort_task)
from repro_torch.configs import get_config, reduced
from repro_torch.core import AsyncFLSimulator, BatchModelTask
from repro_torch.data import FederatedBatcher, SeedAddressedBatcher

LOSS_ATOL, MODEL_ATOL = 5e-6, 1e-5
TINY = dict(n_layers=1, d_model=32, vocab=64)


def _tiny(**task_kw):
    """The reference's and the port's tiny transformer, same weights, and
    a factory of fresh task pairs."""
    jcfg = JC.reduced(JC.get_config("gemma-2b"), **TINY)
    tcfg = reduced(get_config("gemma-2b"), **TINY)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = convert.model_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jp),
                                       device="cpu")
    jb = JD.SeedAddressedBatcher(jcfg, batch_size=2, seq_len=16, seed=3)
    tb = SeedAddressedBatcher(tcfg, batch_size=2, seq_len=16, seed=3,
                              device="cpu")
    return (jp, tp, lambda: JCore.BatchModelTask(jcfg, jp, jb, **task_kw),
            lambda: BatchModelTask(tcfg, tp, tb, **task_kw))


def _np(t):
    if isinstance(t, dict) and t and torch.is_tensor(tree.leaves(t)[0]):
        return [l.detach().float().numpy() for l in tree.leaves(t)]
    return [np.asarray(l, np.float32) for l in jax.tree_util.tree_leaves(t)]


def _max_diff(a, b) -> float:
    return max(float(np.max(np.abs(x - y))) for x, y in zip(_np(a), _np(b)))


def _bits_equal(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree.leaves(a), tree.leaves(b)))


def _ints(res):
    f = res["final"]
    return f["round"], f["messages"], f["broadcasts"]


# --- flat layout ------------------------------------------------------------

def test_flatten_roundtrip_bit_exact_model_params():
    jp, tp, mk_j, mk_t = _tiny()
    ctask = as_cohort_task(mk_t(), 3, device="cpu")
    assert isinstance(ctask, CohortBatchModelTask)
    vec = ctask.flatten(tp)
    assert vec.dtype == torch.float32 and vec.shape == (ctask.D,)
    assert ctask.D == sum(l.numel() for l in tree.leaves(tp))
    # the reference's flat layout, bit for bit
    jvec = JCo.PyTreeFlattener(jp).flatten(jp)
    assert np.array_equal(vec.numpy().view(np.uint32),
                          np.asarray(jvec).view(np.uint32))
    back = ctask.unflatten(vec)
    for a, b in zip(tree.leaves(tp), tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        # f32 leaves are views of the vector, not copies
        assert b.untyped_storage().data_ptr() == \
            vec.untyped_storage().data_ptr()
    assert _bits_equal(tp, back)


def test_flattener_mixed_dtypes_roundtrip():
    t = {"a": torch.tensor([[1.5, -2.25]], dtype=torch.bfloat16),
         "b": (torch.tensor(3.0, dtype=torch.float16),
               torch.arange(5, dtype=torch.float32))}
    flt = PyTreeFlattener(t)
    jflt = JCo.PyTreeFlattener(
        {"a": jnp.asarray([[1.5, -2.25]], jnp.bfloat16),
         "b": (jnp.asarray(3.0, jnp.float16), jnp.arange(5,
                                                         dtype=jnp.float32))})
    assert flt.D == jflt.D == 2 + 1 + 5
    assert flt.offsets == jflt.offsets and flt.shapes == jflt.shapes
    back = flt.unflatten(flt.flatten(t))
    for a, b in zip(tree.leaves(t), tree.leaves(back)):
        assert a.dtype == b.dtype
        assert bool(torch.all(a == b))
    assert back["b"][0].dtype == torch.float16


def test_flattener_rejects_inexact_dtypes():
    """int/bool (and f64) leaves would silently corrupt through the f32
    round trip (int32 above 2**24 loses bits) — rejected up front."""
    for leaf in (torch.arange(3, dtype=torch.int32),
                 torch.zeros((2,), dtype=torch.bool),
                 torch.zeros((2,), dtype=torch.float64)):
        with pytest.raises(TypeError, match="f32"):
            PyTreeFlattener({"i": leaf})


def test_adapter_requires_seed_addressed_batcher():
    jcfg = JC.reduced(JC.get_config("gemma-2b"), **TINY)
    tcfg = reduced(get_config("gemma-2b"), **TINY)
    jp, tp, _, _ = _tiny()
    jtask = JCore.BatchModelTask(
        jcfg, jp, JD.FederatedBatcher(jcfg, batch_size=2, seq_len=16))
    ttask = BatchModelTask(
        tcfg, tp, FederatedBatcher(tcfg, batch_size=2, seq_len=16,
                                   device="cpu"))
    with pytest.raises(TypeError, match="batch_from_key"):
        JCo.as_cohort_task(jtask, 3)
    with pytest.raises(TypeError, match="batch_from_key"):
        as_cohort_task(ttask, 3, device="cpu")
    for engine in (CohortSimulator, DeviceCohortSimulator):
        with pytest.raises(TypeError, match="batch_from_key"):
            engine(ttask, n_clients=3, sizes_per_client=[1],
                   round_stepsizes=[0.1], device="cpu")


# --- trajectory parity ------------------------------------------------------

KW = dict(n_clients=3, sizes_per_client=[[1, 2, 2]] * 3,
          round_stepsizes=[0.1, 0.08, 0.06], d=1, seed=0,
          speeds=[1.0, 0.8, 1.2])


@pytest.fixture(scope="module")
def tiny_runs():
    _, _, mk_j, mk_t = _tiny()
    return {
        "j_event": JCore.AsyncFLSimulator(mk_j(), **KW).run(max_rounds=3),
        "j_cohort": JCo.CohortSimulator(mk_j(), block=4, **KW).run(
            max_rounds=3),
        "event": AsyncFLSimulator(mk_t(), device="cpu", **KW).run(
            max_rounds=3),
        "cohort": CohortSimulator(mk_t(), block=4, device="cpu", **KW).run(
            max_rounds=3),
        "device": DeviceCohortSimulator(mk_t(), block=4, device="cpu",
                                        **KW).run(max_rounds=3),
    }


def test_three_way_model_parity_tiny(tiny_runs):
    """Tiny transformer, deterministic-at-1-tick latency: the port's
    three engines agree (integers exactly, the cohort engines bit for
    bit), and each matches the reference's run of the same engine."""
    r = tiny_runs
    ints = {k: _ints(v) for k, v in r.items()}
    assert len(set(ints.values())) == 1 and ints["event"][0] == 3, ints
    losses = {k: [h["loss"] for h in v["history"]] for k, v in r.items()}
    for k in ("cohort", "device", "j_event", "j_cohort"):
        np.testing.assert_allclose(losses["event"], losses[k], rtol=0,
                                   atol=LOSS_ATOL)
    assert _bits_equal(r["cohort"]["model"], r["device"]["model"])
    assert _max_diff(r["event"]["model"], r["j_event"]["model"]) \
        <= MODEL_ATOL
    assert _max_diff(r["cohort"]["model"], r["j_cohort"]["model"]) \
        <= MODEL_ATOL
    assert _max_diff(r["event"]["model"], r["cohort"]["model"]) \
        <= MODEL_ATOL
    # the reports carry the flat dimension; a model task has no dataset
    for k in ("event", "cohort", "device"):
        rep = r[k]["telemetry"]
        assert rep.flat_dim == r["cohort"]["telemetry"].flat_dim


DP_KW = dict(n_clients=3, sizes_per_client=[[1, 2]] * 3,
             round_stepsizes=[0.1, 0.08], d=2, seed=5,
             speeds=[1.0, 0.7, 1.3], block=2, dp_round_clip=1.0)


def test_device_model_dp_bit_parity_with_host_cohort():
    """DP (per-step clip, round noise through the clip+noise kernels'
    plain versions, round clip) and multi-tick latency: the port's host
    and device engines bit for bit, and both against the reference's
    host engine."""
    _, _, mk_j, mk_t = _tiny(dp_clip=0.5, dp_sigma=1.0)
    # dt = 2 / 1.3; a 4-virtual-second latency spans multiple ticks
    j_co = JCo.CohortSimulator(mk_j(), latency_fn=lambda r: 4.0,
                               **DP_KW).run(max_rounds=2)
    co = CohortSimulator(mk_t(), latency_fn=lambda r: 4.0, device="cpu",
                         **DP_KW).run(max_rounds=2)
    dv = DeviceCohortSimulator(mk_t(), latency=4.0, device="cpu",
                               **DP_KW).run(max_rounds=2)
    assert _bits_equal(co["model"], dv["model"])
    assert _ints(co) == _ints(dv) == _ints(j_co)
    assert _max_diff(co["model"], j_co["model"]) <= MODEL_ATOL
    np.testing.assert_allclose([h["loss"] for h in co["history"]],
                               [h["loss"] for h in j_co["history"]],
                               rtol=0, atol=LOSS_ATOL)


def test_model_dp_noise_perturbs_model():
    kw = dict(n_clients=2, sizes_per_client=[[1, 1]] * 2,
              round_stepsizes=[0.1, 0.08], d=1, seed=0, block=2)
    _, _, _, mk_clean = _tiny()
    _, _, mk_j, mk_noisy = _tiny(dp_clip=0.5, dp_sigma=2.0)
    m0 = CohortSimulator(mk_clean(), device="cpu", **kw).run(
        max_rounds=2)["model"]
    m1 = CohortSimulator(mk_noisy(), device="cpu", **kw).run(
        max_rounds=2)["model"]
    assert _max_diff(m0, m1) > 1e-6
    j1 = JCo.CohortSimulator(mk_j(), **kw).run(max_rounds=2)["model"]
    assert _max_diff(m1, j1) <= MODEL_ATOL
