"""The port's train driver, the protocol on a tiny LM, ``optim`` and
``checkpoint`` against the live reference: twins of
``tests/test_system.py``'s ``test_async_fl_on_tiny_lm_loss_decreases``
and ``test_train_driver_runs`` and of ``tests/test_substrates.py``'s
optim and checkpoint tests (the tasks and ``fl_step`` are in
``tests/test_torch_train.py``).

Sizes: ``reduced()`` configs; the reference's weights carried across by
``convert.model_params_from_jax``.  Tolerances: losses and params within
1e-5 abs (f32 sums reordered; measured <= 1e-6), optimizers within 1e-6
rel; checkpoints bit for bit in both directions.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.core as JCore
import repro.data as JD
from repro.models import init_params as j_init_params
from repro_torch import convert, prng, tree
from repro_torch.checkpoint import (load_fl_state, load_pytree,
                                    save_fl_state, save_pytree)
from repro_torch.configs import get_config, reduced
from repro_torch.core import AsyncFLSimulator, BatchModelTask
from repro_torch.data import FederatedBatcher
from repro_torch.models import init_params, train_loss
from repro_torch.optim import SGD, AdamW

ATOL, OPT_RTOL = 1e-5, 1e-6


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


# --- the protocol on a tiny LM, and the driver ------------------------------

def test_async_fl_on_tiny_lm_loss_decreases():
    """The full protocol driving a (tiny) LM: loss drops, as in the
    reference's run from the same weights (losses within ATOL)."""
    jcfg, tcfg, jp, tp = _pair("gemma-2b", n_layers=1, d_model=64)
    tb = FederatedBatcher(tcfg, batch_size=4, seq_len=32, seed=0,
                          device="cpu")
    jb = JD.FederatedBatcher(jcfg, batch_size=4, seq_len=32, seed=0)
    kw = dict(n_clients=2, sizes_per_client=[[1, 1, 2, 2, 3]] * 2,
              round_stepsizes=[0.5, 0.4, 0.3, 0.25, 0.2], d=1, seed=0)
    sim = AsyncFLSimulator(BatchModelTask(tcfg, tp, tb), device="cpu", **kw)
    loss0 = float(train_loss(tcfg, sim.server.v, tb(0, 0, 0)))
    res = sim.run(max_rounds=5)
    loss1 = float(train_loss(tcfg, res["model"], tb(0, 0, 0)))
    assert loss1 < loss0
    jres = JCore.AsyncFLSimulator(JCore.BatchModelTask(jcfg, jp, jb),
                                  **kw).run(max_rounds=5)
    assert res["final"]["messages"] == jres["final"]["messages"]
    np.testing.assert_allclose([h["loss"] for h in res["history"]],
                               [h["loss"] for h in jres["history"]],
                               rtol=0, atol=ATOL)


def test_train_driver_runs(tmp_path):
    """``main`` on the CPU writes a checkpoint that loads back into a
    template of the model (checkpoints cross to the reference in
    ``test_checkpoints_cross_between_the_packages``)."""
    from repro_torch.launch import train as train_mod
    args = ["--arch", "gemma-2b", "--reduced", "--rounds", "3",
            "--clients", "2", "--batch", "2", "--seq", "32"]
    ck = str(tmp_path / "ck")
    assert train_mod.main(args + ["--checkpoint", ck, "--device", "cpu"]) \
        == 0
    assert os.path.exists(os.path.join(ck, "global_model.npz"))
    cfg = reduced(get_config("gemma-2b"))
    tmpl = init_params(cfg, prng.PRNGKey(1), torch.float32, device="cpu")
    model, k = load_fl_state(ck, tmpl)
    assert k == 3 and _max_diff(model, tmpl) > 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_mod.main(args)


# --- optim ------------------------------------------------------------------

def test_sgd_descends_quadratic():
    opt = SGD()
    params = {"x": torch.tensor(5.0)}
    state = opt.init(params)
    for _ in range(50):
        params, state = opt.update({"x": 2.0 * params["x"]}, state, params,
                                   0.1)
    assert abs(float(params["x"])) < 0.01


def test_sgd_momentum_faster_on_illconditioned():
    def loss_grad(x):
        return (x[0] ** 2 + 50.0 * x[1] ** 2,
                torch.stack([2.0 * x[0], 100.0 * x[1]]))
    results = {}
    for momentum in (0.0, 0.8):
        opt = SGD(momentum=momentum)
        params = {"x": torch.tensor([3.0, 3.0])}
        state = opt.init(params)
        for _ in range(120):
            params, state = opt.update({"x": loss_grad(params["x"])[1]},
                                       state, params, 0.005)
        results[momentum] = float(loss_grad(params["x"])[0])
    assert results[0.8] < results[0.0]


def test_adamw_converges():
    opt = AdamW(weight_decay=0.0)
    params = {"w": torch.ones((4,)) * 4.0}
    state = opt.init(params)
    for _ in range(300):
        params, state = opt.update({"w": 2.0 * params["w"]}, state, params,
                                   0.05)
    assert float(params["w"].abs().max()) < 0.05


@pytest.mark.parametrize("name,kw", [("sgd", {}),
                                     ("sgd", dict(momentum=0.9)),
                                     ("sgd", dict(momentum=0.9,
                                                  nesterov=True)),
                                     ("adamw", dict(weight_decay=0.01))])
def test_optimizers_match_reference(name, kw):
    from repro import optim as joptim
    from repro_torch import optim as toptim
    jopt = (joptim.SGD if name == "sgd" else joptim.AdamW)(**kw)
    topt = (toptim.SGD if name == "sgd" else toptim.AdamW)(**kw)
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = jax.tree_util.tree_map(torch.tensor, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p0.items()}
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                             0.1)
        tp, ts = topt.update(jax.tree_util.tree_map(torch.tensor, g), ts, tp,
                             0.1)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=OPT_RTOL, atol=1e-7)


# --- checkpoint -------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    t = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)}}
    path = os.path.join(tmp_path, "ckpt.npz")
    save_pytree(path, t, metadata={"round": 7})
    restored = load_pytree(path, t)
    assert torch.equal(restored["a"], t["a"])
    assert restored["nested"]["b"].dtype == torch.bfloat16


def test_fl_state_roundtrip(tmp_path):
    model = {"w": torch.ones((8,))}
    save_fl_state(str(tmp_path), global_model=model, server_k=42,
                  client_states={0: {"i": 5, "k": 4}})
    restored, k = load_fl_state(str(tmp_path), model)
    assert k == 42
    assert torch.equal(restored["w"], model["w"])


def test_checkpoints_cross_between_the_packages(tmp_path):
    """Written by either package, loaded by the other: the same npz keys
    and manifest, bf16 widened to f32 and restored, lists by index."""
    from repro.checkpoint import load_pytree as j_load
    from repro.checkpoint import save_pytree as j_save
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 3)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    jt = {"a": jnp.asarray(a), "n": {"b": jnp.asarray(b, jnp.bfloat16),
                                     "l": [jnp.arange(3, dtype=jnp.int32)]}}
    tt = {"a": torch.tensor(a), "n": {"b": torch.tensor(b).to(
        torch.bfloat16), "l": [torch.arange(3, dtype=torch.int32)]}}
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_save(jpath, jt, metadata={"r": 1})
    save_pytree(tpath, tt, metadata={"r": 1})
    with open(jpath + ".json") as f1, open(tpath + ".json") as f2:
        assert f1.read() == f2.read()
    got = load_pytree(jpath, tt)
    jgot = j_load(tpath, jt)
    for x, y in zip(tree.leaves(got), tree.leaves(tt)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for x, y in zip(jax.tree_util.tree_leaves(jgot),
                    jax.tree_util.tree_leaves(jt)):
        assert x.dtype == y.dtype and bool(jnp.all(x == y))
