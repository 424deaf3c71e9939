"""The port's population SGD block (CohortLogRegTask.run_block) against the
reference's vmapped scan (repro.cohort.tasks.CohortLogRegTask.block_body).

The sample indices are bitwise (test_torch_prng.py); the floats differ
by XLA's dot and exp against the client block's lane-ordered sums and
PyTorch's exp over a few block steps, held to rtol 1e-5 / atol 1e-6.
The port runs each client's own ``n[c]`` steps, the reference ``block``
steps masked past ``n[c]``: the test's ``n`` is ragged.
"""
import numpy as np
import pytest
import torch

from repro.cohort.tasks import CohortLogRegTask as JaxCohortTask
from repro.core import LogRegTask as JaxLogRegTask
from repro.data import make_binary_dataset as jax_make_binary_dataset
from repro_torch.cohort.tasks import CohortLogRegTask
from repro_torch.core import LogRegTask, clip_tree
from repro_torch.data import make_binary_dataset

RTOL, ATOL = 1e-5, 1e-6


def test_dataset_is_bit_identical():
    a = jax_make_binary_dataset(500, 12, seed=9, noise=0.3)
    b = make_binary_dataset(500, 12, seed=9, noise=0.3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dp_clip", [0.0, 0.1])
def test_run_block_matches_block_body(dp_clip):
    C, d, block, n_data = 12, 12, 8, 300
    X, y = make_binary_dataset(n_data, d, seed=9, noise=0.3)
    kw = dict(l2=1.0 / n_data, dp_clip=dp_clip, sample_seed=21)
    jt = JaxCohortTask(JaxLogRegTask(X, y, **kw), C)
    tt = CohortLogRegTask(LogRegTask(X, y, **kw), C, device="cpu")
    rng = np.random.default_rng(0)
    w = (0.1 * rng.normal(size=(C, d + 1))).astype(np.float32)
    U = (0.1 * rng.normal(size=(C, d + 1))).astype(np.float32)
    i = rng.integers(0, 5, C).astype(np.int32)
    h = rng.integers(0, 20, C).astype(np.int32)
    n = rng.integers(0, block + 1, C).astype(np.int32)   # ragged n
    n[:3] = 0, 1, block               # an idle client, one step, all
    eta = (0.1 * rng.random(C)).astype(np.float32)
    w_j, U_j = jt.run_block(w, U, i, h, n, eta, block)
    w_t, U_t = tt.run_block(*(torch.as_tensor(a) for a in (w, U, i, h, n,
                                                           eta)), block)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), rtol=RTOL,
                               atol=ATOL)
    # n = 0 takes no step: the rows pass through bitwise
    assert torch.equal(w_t[0].view(torch.int32),
                       torch.as_tensor(w[0]).view(torch.int32))
    assert torch.equal(U_t[0].view(torch.int32),
                       torch.as_tensor(U[0]).view(torch.int32))


def test_per_example_grad_matches_jax_grad():
    import jax
    from repro.models import logreg as jlogreg
    from repro_torch.models import logreg
    rng = np.random.default_rng(1)
    N, d, l2 = 64, 12, 0.01
    x = rng.normal(size=(N, d)).astype(np.float32)
    w = (0.3 * rng.normal(size=(N, d))).astype(np.float32)
    b = (0.1 * rng.normal(size=N)).astype(np.float32)
    y = (rng.random(N) > 0.5).astype(np.float32)
    # z == 0 exactly: the max/abs tie rules decide the gradient
    x[0] = 0.0
    b[0] = 0.0
    g = jax.vmap(lambda wi, bi, xi, yi: jax.grad(jlogreg.per_example_loss)(
        {"w": wi, "b": bi}, xi, yi, l2))(w, b, x, y)
    gw, gb = logreg.per_example_grad(*(torch.as_tensor(a)
                                       for a in (w, b, x, y)), l2)
    np.testing.assert_allclose(gw.numpy(), np.asarray(g["w"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(gb.numpy(), np.asarray(g["b"]), rtol=1e-6,
                               atol=1e-7)
    assert gb[0].item() == float(np.asarray(g["b"])[0])


@pytest.mark.parametrize("shape", [(12,), (64, 12), (3, 5, 12)])
def test_predict_logits_matches_reference(shape):
    """``models.logreg.predict_logits``: x·w + b for one example, a batch
    and a batch of batches, against the reference's (the dot's sums
    reordered: rtol 1e-6)."""
    from repro.models import logreg as jlogreg
    from repro_torch.models import logreg
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).astype(np.float32)
    p = {"w": rng.normal(size=shape[-1]).astype(np.float32),
         "b": np.float32(0.25)}
    want = np.asarray(jlogreg.predict_logits(p, x))
    got = logreg.predict_logits({k: torch.as_tensor(v) for k, v in
                                 p.items()}, torch.as_tensor(x))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_clip_tree_global_norm_over_w_and_b():
    """``clip_tree(tree, clip)`` (the reference's signature): one global
    norm over the ``w`` and ``b`` leaves of each gradient tree."""
    gw = torch.tensor([[3.0, 0.0], [0.3, 0.0]])
    gb = torch.tensor([4.0, 0.4])
    rows = [clip_tree({"w": gw[i], "b": gb[i]}, 1.0) for i in range(2)]
    cw = torch.stack([r["w"] for r in rows])
    cb = torch.stack([r["b"] for r in rows])
    # row 0: norm 5 -> scaled to 1; row 1: norm 0.5 -> untouched
    np.testing.assert_allclose(cw.numpy(), [[0.6, 0.0], [0.3, 0.0]],
                               rtol=1e-6)
    np.testing.assert_allclose(cb.numpy(), [0.8, 0.4], rtol=1e-6)


@pytest.mark.parametrize("kind", ["power", "linear", "constant", "ilog"])
def test_protocol_scalars_match_reference(kind):
    """Round sizes and round step sizes (pure Python copies)."""
    from repro.configs.base import SampleSequenceConfig as JSeq
    from repro.configs.base import StepSizeConfig as JStep
    from repro.configs.paper_logreg import fl_config_fig1b as j_fig1b
    from repro.core import sequences as jseq
    from repro.core import stepsizes as jstep
    from repro_torch.configs import (SampleSequenceConfig,
                                     StepSizeConfig, fl_config_fig1b)
    from repro_torch.core import sequences, stepsizes
    if kind == "power":
        jcfg, tcfg = j_fig1b(), fl_config_fig1b()
        assert tcfg.sample_seq.__dict__ == jcfg.sample_seq.__dict__
        assert tcfg.step_size.__dict__ == jcfg.step_size.__dict__
        assert tcfg.dp.__dict__ == jcfg.dp.__dict__
        js, ts = jcfg.sample_seq, tcfg.sample_seq
    else:
        kw = dict(kind=kind, s0=16, a=1.5, m=3.0, d=2)
        js, ts = JSeq(**kw), SampleSequenceConfig(**kw)
    sizes = sequences.sample_sizes(ts, 40)
    assert sizes == jseq.sample_sizes(js, 40)
    assert sequences.rounds_for_budget(ts, 2000) == \
        jseq.rounds_for_budget(js, 2000)
    for sk in ("constant", "inv_t", "inv_sqrt"):
        kw = dict(kind=sk, eta0=0.15, beta=0.001)
        assert stepsizes.round_stepsizes(StepSizeConfig(**kw), sizes) == \
            jstep.round_stepsizes(JStep(**kw), sizes)
    assert stepsizes.theorem5_round_stepsizes(0.1, sizes, m=3, d=2) == \
        jstep.theorem5_round_stepsizes(0.1, sizes, m=3, d=2)
