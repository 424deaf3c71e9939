"""The port's ``core/fl_step.py`` and ``configs.RunConfig`` against the
live reference: ``make_train_step`` with and without DP, over 1 and 2
client shards, and twins of ``tests/test_system.py``'s ``fl_step`` tests.

Sizes: the tiny transformer of ``tests/test_cohort_model_parity.py`` (1
layer, d_model 32, vocab 64) or ``reduced()`` cut to 1 layer, d_model
64; the reference's weights carried across by
``convert.model_params_from_jax``.  Tolerances: params, losses and update
norms within 1e-5 (f32 sums reordered; measured <= 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.data as JD
from repro.core import fl_step as jfl
from repro.models import init_params as j_init_params
from repro_torch import convert, prng, tree
from repro_torch.configs import (DPConfig, FLConfig, RunConfig, get_config,
                                 reduced)
from repro_torch.core import fl_step
from repro_torch.data import FederatedBatcher
from repro_torch.models import init_params

ATOL = 1e-5
TINY = dict(n_layers=1, d_model=32, vocab=64)


def _pair(arch, **red):
    """(reference cfg, port cfg, reference params, port params): the
    reference's f32 weights carried across."""
    jcfg = JC.reduced(JC.get_config(arch), **red)
    tcfg = reduced(get_config(arch), **red)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = convert.model_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _np(t):
    if torch.is_tensor(tree.leaves(t)[0]):
        return [l.detach().float().numpy() for l in tree.leaves(t)]
    return [np.asarray(l, np.float32) for l in jax.tree_util.tree_leaves(t)]


def _max_diff(a, b) -> float:
    return max(float(np.max(np.abs(x - y))) for x, y in zip(_np(a), _np(b)))


# --- fl_step ----------------------------------------------------------------

@pytest.mark.parametrize("shards,dp", [(1, False), (1, True), (2, False),
                                       (2, True)])
def test_fl_train_step_matches_reference(shards, dp):
    jcfg, tcfg, jp, tp = _pair("gemma-2b", **TINY)
    dpc = dict(enabled=True, clip_norm=0.5, sigma=0.01) if dp else {}
    jrun = JC.RunConfig(model=jcfg, fl=JC.FLConfig(dp=JC.DPConfig(**dpc)))
    trun = RunConfig(model=tcfg, fl=FLConfig(dp=DPConfig(**dpc)))
    jstep = jfl.make_train_step(jcfg, jrun, n_client_shards=shards,
                                client_axis=None)
    tstep = fl_step.make_train_step(tcfg, trun, n_client_shards=shards)
    jbat = JD.FederatedBatcher(jcfg, batch_size=2, seq_len=16, seed=0)
    tbat = FederatedBatcher(tcfg, batch_size=2, seq_len=16, seed=0,
                            device="cpu")
    jnew, _, jm = jstep(jp, None, jbat.global_batch(shards, 0),
                        jnp.float32(0.01), jax.random.PRNGKey(1))
    tnew, _, tm = tstep(tp, None, tbat.global_batch(shards, 0), 0.01,
                        prng.PRNGKey(1))
    assert _max_diff(tnew, jnew) <= ATOL
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= ATOL
    assert abs(float(tm["update_norm"]) - float(jm["update_norm"])) \
        <= ATOL * max(1.0, float(jm["update_norm"]))


def test_fl_train_step_descends_and_dp_clips_update():
    """Twins of ``test_fl_train_step_descends_and_matches_protocol`` and
    ``test_fl_train_step_dp_clips_update``."""
    cfg = reduced(get_config("gemma-2b"), n_layers=1, d_model=64)
    params = init_params(cfg, prng.PRNGKey(0), torch.float32, device="cpu")
    batch = FederatedBatcher(cfg, batch_size=2, seq_len=32, seed=0,
                             device="cpu").global_batch(1, 0)
    step = fl_step.make_train_step(cfg, RunConfig(model=cfg),
                                   n_client_shards=1, client_axis=None)
    new, _, m = step(params, None, batch, 0.01, prng.PRNGKey(1))
    assert bool(torch.isfinite(m["loss"]))
    assert sum(float((a - b).abs().sum()) for a, b in zip(
        tree.leaves(params), tree.leaves(new))) > 0.0
    fl = FLConfig(dp=DPConfig(enabled=True, clip_norm=0.01, sigma=0.0))
    step = fl_step.make_train_step(cfg, RunConfig(model=cfg, fl=fl),
                                   n_client_shards=1, client_axis=None)
    _, _, m = step(params, None, batch, 0.01, prng.PRNGKey(1))
    assert float(m["update_norm"]) <= 0.01 * 1.01
    tokens = batch["tokens"][0]
    logits = fl_step.make_prefill_step(cfg, RunConfig(model=cfg))(
        params, {"tokens": tokens})
    assert logits.shape[0] == 2 and bool(torch.isfinite(logits).all())


def test_run_config_fields_equal_reference():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(JC.RunConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(RunConfig)}
    assert list(jf) == list(tf)
    assert {k: v for k, v in jf.items() if k != "fl"} == \
        {k: v for k, v in tf.items() if k != "fl"}
