"""The training half of the port's model-scale path against the live
reference: ``BatchModelTask`` (step, round noise, metrics), the event
simulator's clients on a params tree and the repaired tree clip.
``fl_step`` is in ``tests/test_torch_fl_step.py``; the driver, ``optim``
and ``checkpoint`` in ``tests/test_torch_train_driver.py``.

Sizes: ``reduced()`` configs cut to 1 layer, d_model 32–64 (the tiny
transformer of ``tests/test_cohort_model_parity.py``); the reference's
weights carried across by ``convert.model_params_from_jax``.
Tolerances: params, updates and losses within 1e-5 abs (f32 sums
reordered across layers and leaves; measured <= 1e-6), round noise
within 1e-6 abs beside that (the port's normals are within a few ulp of
jax's); the clip repair bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.core as JCore
import repro.data as JD
from repro.core import tasks as jtasks
from repro.models import init_params as j_init_params
from repro.models import train_loss as j_train_loss
from repro_torch import convert, prng, tree
from repro_torch.configs import get_config, reduced
from repro_torch.core import BatchModelTask, Client
from repro_torch.core.tasks import clip_tree, global_norm
from repro_torch.data import SeedAddressedBatcher
from repro_torch.models.attention import dense_attention
from repro_torch.models.ssm import ssd_chunked

ATOL, NOISE_ATOL = 1e-5, 1e-6
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


# --- step 0: the two repaired faults ----------------------------------------

def test_client_takes_its_device_from_the_first_leaf():
    """A params tree without a top-level "w" builds a client (it raised
    KeyError), and its zero update lies on that tree's device."""
    _, tcfg, _, tp = _pair("gemma-2b", **TINY)
    task = BatchModelTask(tcfg, tp, SeedAddressedBatcher(
        tcfg, batch_size=1, seq_len=8, device="cpu"))
    cl = Client(0, tp, task, [1, 2], [0.1, 0.05], d=1, seed=0)
    assert tree.leaves(cl.U)[0].device == tree.leaves(tp)[0].device
    assert all(u.dtype == torch.float32 and not bool(u.any())
               for u in tree.leaves(cl.U))
    cl.run(1)
    msg = cl.finish_round()
    assert _max_diff(msg.U, cl.U) > 0.0      # a fresh zero update


@pytest.mark.parametrize("clip", [1e-3, 1e4])
def test_global_norm_and_clip_tree_over_nested_trees(clip):
    """The reference's contract: any tree, leaves in jax's order, bf16
    leaves clipped into f32."""
    rng = np.random.default_rng(0)
    leaves = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "z": {"b": rng.standard_normal((5,)).astype(np.float32),
                    "c": [rng.standard_normal(2).astype(np.float32)]}}
    jt = jax.tree_util.tree_map(jnp.asarray, leaves)
    tt = jax.tree_util.tree_map(torch.tensor, leaves)
    assert float(global_norm(tt)) == float(jtasks.global_norm(jt))
    jc, tc = jtasks.clip_tree(jt, clip), clip_tree(tt, clip)
    for a, b in zip(jax.tree_util.tree_leaves(jc), tree.leaves(tc)):
        assert np.array_equal(b.numpy(), np.asarray(a))
    jb = jtasks.clip_tree({"x": jnp.asarray(leaves["a"], jnp.bfloat16)},
                          clip)
    tb = clip_tree({"x": torch.tensor(leaves["a"]).to(torch.bfloat16)}, clip)
    assert tb["x"].dtype == torch.float32 and jb["x"].dtype == jnp.float32
    assert np.array_equal(tb["x"].numpy(), np.asarray(jb["x"]))


# --- BatchModelTask ---------------------------------------------------------

@pytest.mark.parametrize("arch,clip", [("gemma-2b", 0.0),
                                       ("gemma-2b", 0.5),
                                       ("mamba2-780m", 0.0)])
def test_batch_model_task_matches_reference(arch, clip):
    """Two minibatch steps of one client from one model, the round noise
    and the metrics probe, against the reference's task."""
    red = dict(n_layers=1, d_model=64, vocab=128)
    jcfg, tcfg, jp, tp = _pair(arch, **red)
    jb = JD.SeedAddressedBatcher(jcfg, batch_size=2, seq_len=16, seed=1)
    tb = SeedAddressedBatcher(tcfg, batch_size=2, seq_len=16, seed=1,
                              device="cpu")
    jt = JCore.BatchModelTask(jcfg, jp, jb, dp_clip=clip, dp_sigma=2.0
                              if clip else 0.0)
    tt = BatchModelTask(tcfg, tp, tb, dp_clip=clip,
                        dp_sigma=2.0 if clip else 0.0)
    assert tt.attn_core is dense_attention and tt.ssd_fn is ssd_chunked
    kw = dict(round_idx=1, client_id=2, start_h=3, n_iters=2, eta=0.05)
    jw, jU = jt.run_iterations(jp, jt.zero_update(),
                               rng=jax.random.PRNGKey(4), **kw)
    tw, tU = tt.run_iterations(tp, tt.zero_update(),
                               rng=prng.PRNGKey(4), **kw)
    assert _max_diff(tw, jw) <= ATOL and _max_diff(tU, jU) <= ATOL
    assert abs(tt.last_loss - jt.last_loss) <= ATOL
    if clip:
        jw2, jU2 = jt.add_round_noise(jw, jU, eta=0.05,
                                      rng=jax.random.PRNGKey(9))
        tw2, tU2 = tt.add_round_noise(tw, tU, eta=0.05, rng=prng.PRNGKey(9))
        assert _max_diff(tU2, jU2) <= NOISE_ATOL + ATOL
        assert _max_diff(tw2, jw2) <= NOISE_ATOL + ATOL
        assert _max_diff(tU2, tU) > 1.0        # std clip * sigma = 1
    jm, tm = jt.metrics(jw), tt.metrics(tw)
    assert abs(tm["loss"] - jm["loss"]) <= ATOL
    assert tm["last_train_loss"] == tt.last_loss


def test_batch_model_task_gradient_is_the_plain_cores():
    """The step's gradient is the gradient of ``train_loss`` through the
    cores the task names: an autograd pass through them, the same as the
    reference's ``jax.grad``."""
    jcfg, tcfg, jp, tp = _pair("gemma-2b", **TINY)
    tb = SeedAddressedBatcher(tcfg, batch_size=2, seq_len=16, seed=1,
                              device="cpu")
    task = BatchModelTask(tcfg, tp, tb)
    batch = tb(0, 0, 0)
    loss, g = task.loss_and_grad(tp, batch)
    jloss, jg = jax.value_and_grad(
        lambda p: j_train_loss(jcfg, p, {"tokens": jnp.asarray(
            batch["tokens"].numpy())}))(jp)
    assert abs(float(loss) - float(jloss)) <= ATOL
    assert max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
               for a, b in zip(g, jax.tree_util.tree_leaves(jg))) <= ATOL


def test_ssd_chunked_gradient_is_finite_where_the_reference_overflows():
    """The chunked SSD's intra-chunk decay exp(dA_cum[i] - dA_cum[j]) is
    masked to j <= i; above the diagonal the exponent is positive and
    overflows at mamba2-780m's width (chunk 128), and the reference's
    ``where`` after the ``exp`` makes its gradient NaN (0 * inf).  The
    port masks first: the same outputs bit for bit, a finite gradient."""
    from repro.models import ssm as jssm
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 64, 2, 4, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), 2.0, np.float32)
    A = np.asarray([-1.0, -2.0], np.float32)       # dA * 64 steps: e^256
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)

    def jloss(dd):
        return jnp.sum(jssm.ssd_chunked(jnp.asarray(x), dd, jnp.asarray(A),
                                        jnp.asarray(B), jnp.asarray(C),
                                        64)[0])

    jy = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), 64)[0]
    assert not bool(jnp.isfinite(jax.grad(jloss)(jnp.asarray(dt))).all())
    tdt = torch.tensor(dt, requires_grad=True)
    ty = ssd_chunked(torch.tensor(x), tdt, *map(torch.tensor, (A, B, C)),
                     64)[0]
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    g, = torch.autograd.grad(ty.sum(), tdt)
    assert bool(torch.isfinite(g).all())
