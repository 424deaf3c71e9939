"""Remat in the port: each layer body (each (local, global) pair under
``REPRO_CHUNKED_LOCAL``) and each loss chunk through
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``.

For every assigned architecture at ``reduced()`` size (2 layers, B 2,
S 24), with the reference's weights carried across
(``convert.model_params_from_jax``): the loss and every gradient are
bit for bit equal between ``remat=True`` and ``remat=False``; the
forward with remat on keeps fewer bytes for backward (counted through
``torch.autograd.graph.saved_tensors_hooks``: a checkpointed body's
saves go to its own hooks and are dropped); the loss and gradient match
the reference's ``train_loss(remat=True)`` and its ``jax.grad`` within
``tests/test_torch_models.py``'s f32 tolerance (2e-5 abs + rel); and
prefill under ``no_grad`` checkpoints nothing and is unchanged bit for
bit.  Then the pair path, the task, the cohort adapter and the FL step
carrying ``remat``, and the sharding specs installed again for a rerun.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import repro.configs as JC
import repro.models as JM
import repro_torch.configs as TC
import repro_torch.models as TM
from repro.data import make_batch
from repro_torch import convert, prng, tree
from repro_torch.models import transformer as ttr
from repro_torch.models.attention import dense_attention
from repro_torch.models.ssm import ssd_chunked

TOL = 2e-5
ARCHS = JC.ASSIGNED_ARCHS


@functools.lru_cache(maxsize=None)
def _setup(arch, B=2, S=24):
    """The reference's params and the port's copy of them, and a batch
    (shared by the tests, which do not write them)."""
    jc = JC.reduced(JC.get_config(arch))
    tc = TC.reduced(TC.get_config(arch))
    jp = JM.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    tp = convert.model_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    b = make_batch(jc, B, S, seed=1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    return jc, tc, jp, tp, jb, tb


def _loss_and_grad(cfg, params, batch, remat):
    """(loss, gradients in leaf order, bytes saved for backward outside a
    checkpointed body)."""
    flat = [l.detach().requires_grad_(True) for l in tree.leaves(params)]
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = TM.train_loss(cfg, tree.unflatten(params, flat), batch,
                             remat=remat, attn_core=dense_attention,
                             ssd_fn=ssd_chunked)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(flat, grads)], saved[0]


def _bitwise(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.reshape(-1).numpy().view(np.uint8),
                               b.reshape(-1).numpy().view(np.uint8)))


class _Counted:
    """``torch.utils.checkpoint.checkpoint`` counting its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return torch.utils.checkpoint.checkpoint(*args, **kw)


@pytest.fixture
def counted(monkeypatch):
    c = _Counted()
    monkeypatch.setattr(ttr, "checkpoint", c)
    return c


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_and_keeps_fewer_saved_bytes(arch, counted):
    _, tc, _, tp, _, tb = _setup(arch)
    l1, g1, s1 = _loss_and_grad(tc, tp, tb, True)
    n_on = counted.calls
    l0, g0, s0 = _loss_and_grad(tc, tp, tb, False)
    assert _bitwise(l1, l0)
    assert all(_bitwise(a, b) for a, b in zip(g1, g0))
    assert s1 < s0, (s1, s0)
    # remat on: every layer body (the encoder's too) and every loss
    # chunk; off: the loss chunks alone (one chunk of S - 1 positions)
    layers = tc.n_layers + (tc.n_encoder_layers if tc.family == "encdec"
                            else 0)
    assert n_on == layers + 1
    assert counted.calls - n_on == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_the_reference_grad(arch):
    jc, tc, jp, tp, jb, tb = _setup(arch)
    jl, jg = jax.value_and_grad(
        lambda p: JM.train_loss(jc, p, jb, remat=True))(jp)
    tl, tg, _ = _loss_and_grad(tc, tp, tb, True)
    jl = float(jl)
    assert abs(float(tl) - jl) <= TOL * (1 + abs(jl))
    for a, b in zip(tg, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_under_no_grad_is_unchanged(arch, counted):
    _, tc, _, tp, _, tb = _setup(arch)
    with torch.no_grad():
        on = TM.forward_prefill(tc, tp, tb, remat=True)
        off = TM.forward_prefill(tc, tp, tb, remat=False)
        loss = TM.train_loss(tc, tp, tb, remat=True)
    assert counted.calls == 0
    assert _bitwise(on, off)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("chunk,n_chunks", [(16, 3), (40, 1)])
def test_chunked_loss_checkpoints_every_chunk(chunk, n_chunks, counted):
    """Each chunk's unembed, log_softmax and gather run again in
    backward, with no ``remat`` to ask (the reference's ``@jax.checkpoint
    one``); the loss is bit for bit the same pass's under ``no_grad``,
    which checkpoints nothing, and the gradient reaches the hidden
    states."""
    _, tc, _, tp, _, _ = _setup("gemma2-2b")
    g = torch.Generator().manual_seed(2)
    hidden = torch.randn(2, 40, tc.d_model, generator=g, requires_grad=True)
    labels = torch.randint(0, tc.vocab_size, (2, 40), generator=g)
    mask = (torch.rand(2, 40, generator=g) > 0.3).to(torch.int32)
    loss = ttr.chunked_loss(tc, tp, hidden, labels, mask, chunk=chunk)
    assert counted.calls == n_chunks            # 40 -> 48 in 3 of 16
    gh, = torch.autograd.grad(loss, hidden)
    with torch.no_grad():
        plain = ttr.chunked_loss(tc, tp, hidden, labels, mask, chunk=chunk)
    assert counted.calls == n_chunks
    assert _bitwise(loss.detach(), plain)
    assert torch.isfinite(gh).all() and bool(gh.abs().sum() > 0)


def test_chunked_local_pairs_remat(monkeypatch, counted):
    """Under ``REPRO_CHUNKED_LOCAL=1`` each (local, global) pair is one
    checkpointed body: bit for bit against remat off, and the gradient
    against the reference's pair scan under ``jax.checkpoint``."""
    jc, tc, jp, tp, _, _ = _setup("gemma2-2b")
    jc = dataclasses.replace(jc, sliding_window=16)
    tc = dataclasses.replace(tc, sliding_window=16)
    tokens = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 65),
                                               dtype=np.int32)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.as_tensor(
        tokens)}
    monkeypatch.setenv("REPRO_CHUNKED_LOCAL", "1")
    l1, g1, _ = _loss_and_grad(tc, tp, tb, True)
    assert counted.calls == tc.n_layers // 2 + 1
    l0, g0, _ = _loss_and_grad(tc, tp, tb, False)
    assert _bitwise(l1, l0) and all(_bitwise(a, b) for a, b in zip(g1, g0))
    jl, jg = jax.value_and_grad(
        lambda p: JM.train_loss(jc, p, jb, remat=True))(jp)
    assert abs(float(l1) - float(jl)) <= TOL * (1 + abs(float(jl)))
    for a, b in zip(g1, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


def test_task_and_cohort_adapter_carry_remat(counted):
    """``BatchModelTask(remat=)`` reaches ``train_loss``, and the flat
    cohort adapter steps through it: both remat settings give the same
    blocks bit for bit, and only ``remat=True`` checkpoints the layers."""
    from repro_torch.cohort import CohortBatchModelTask
    from repro_torch.core import BatchModelTask
    from repro_torch.data import SeedAddressedBatcher
    tc = TC.reduced(TC.get_config("mamba2-780m"), n_layers=2, d_model=64,
                    vocab=128)
    tp = TM.init_params(tc, prng.PRNGKey(0), torch.float32, device="cpu")
    batcher = SeedAddressedBatcher(tc, batch_size=2, seq_len=16, seed=1,
                                   device="cpu")
    out, calls = {}, {}
    for remat in (True, False):
        task = BatchModelTask(tc, tp, batcher, remat=remat)
        assert task.remat is remat
        ct = CohortBatchModelTask(task, 2, device="cpu")
        w = ct.init_flat()[None].repeat(2, 1)
        U = torch.zeros_like(w)
        before = counted.calls
        out[remat] = ct.run_block(
            w, U, torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
            torch.tensor([2, 1], dtype=torch.int32),
            torch.tensor([0.1, 0.05]), 2)
        calls[remat] = counted.calls - before
    for a, b in zip(out[True], out[False]):
        assert _bitwise(a, b)
    # 2 clients x 2 steps; each: 2 layers + 1 loss chunk, or the chunk
    assert calls == {True: 12, False: 4}


def test_fl_step_carries_run_config_remat():
    from repro_torch.configs import RunConfig
    from repro_torch.core import fl_step
    tc = TC.reduced(TC.get_config("gemma2-2b"), n_layers=2, d_model=64,
                    vocab=128)
    tp = TM.init_params(tc, prng.PRNGKey(0), torch.float32, device="cpu")
    tokens = torch.randint(0, tc.vocab_size, (2, 2, 17),
                           generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    res = {}
    for remat in (True, False):
        step = fl_step.make_train_step(
            tc, RunConfig(model=tc, remat=remat), n_client_shards=2)
        res[remat] = step(tp, None, {"tokens": tokens}, 0.05,
                          prng.PRNGKey(1))
    for a, b in zip(tree.leaves(res[True][0]), tree.leaves(res[False][0])):
        assert _bitwise(a, b)
    assert _bitwise(res[True][2]["loss"], res[False][2]["loss"])


def test_rerun_installs_the_specs_of_its_call():
    """A checkpointed body runs again in backward with the sharding specs
    installed at its call, wherever the backward runs."""
    from repro_torch.sharding import context
    from repro_torch.sharding.specs import P
    seen = []

    def body(x):
        seen.append(context.activation_spec())
        return torch.sin(x)

    x = torch.randn(4, requires_grad=True)
    with context.use_activation_spec(P("data")):
        y = ttr.rematerialized(body)(x)
    assert context.activation_spec() is None
    y.sum().backward()
    assert seen == [P("data"), P("data")]
    assert torch.equal(x.grad, torch.cos(x.detach()))
