"""The port's example-level DP round (``repro_torch.dp.mechanism``, the
``dp_clip`` kernel's plain route) against the live JAX reference.

Tolerances: a clipped sum reorders its adds across frameworks, so each
output is held to ``SUM_RTOL * sum|terms|``; the noise normals are
jax's within ``NORMAL_ULP`` (``tests/test_torch_prng.py``), so a noised
output may differ by that many ulp of ``stddev * |n|`` more; losses
within rtol 1e-5.  The JAX ``dp_clip`` ops run as the reference suite
runs them on the CPU: the Pallas kernel in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dp import mechanism as jmech
from repro.kernels import dp_clip as jclip
from repro.models import logreg as jlogreg
from repro_torch import prng, tree
from repro_torch.dp import mechanism as tmech
from repro_torch.kernels import dp_clip as tclip
from repro_torch.models import logreg as tlogreg

SUM_RTOL = 1e-5
NORMAL_ULP = 4
EPS = float(np.finfo(np.float32).eps)


def _np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _sum_terms(G, clip):
    """sum_n |G[n, d]| * min(1, clip / ||G[n]||) (numpy, f64)."""
    G = np.asarray(G, np.float64)
    s = 1.0 / np.maximum(1.0, np.linalg.norm(G, axis=1) / clip)
    return np.abs(G * s[:, None]).sum(0)


def _grads_tree(rng, N):
    return {"w": rng.standard_normal((N, 6, 5)).astype(np.float32) * 2.0,
            "b": rng.standard_normal((N, 5)).astype(np.float32),
            "a": [rng.standard_normal((N,)).astype(np.float32),
                  rng.standard_normal((N, 3)).astype(np.float32)]}


def test_tree_leaves_follow_jax_order():
    rng = np.random.default_rng(0)
    t = _grads_tree(rng, 4)
    want = jax.tree_util.tree_leaves(t)
    got = tree.leaves({k: v for k, v in reversed(list(t.items()))})
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a is b
    rebuilt = tree.unflatten(t, [np.zeros(1)] * len(want))
    assert list(rebuilt) == list(t) and len(rebuilt["a"]) == 2


@pytest.mark.parametrize("clip", [0.05, 1.0, 100.0])
def test_tree_norm_and_clip_tree_match_reference(clip):
    rng = np.random.default_rng(1)
    t = {"w": rng.standard_normal((10, 7)).astype(np.float32),
         "b": rng.standard_normal((7,)).astype(np.float32)}
    jt = {k: jnp.asarray(v) for k, v in t.items()}
    tt = {k: torch.tensor(v) for k, v in t.items()}
    np.testing.assert_allclose(float(tmech.tree_norm(tt)),
                               float(jmech.tree_norm(jt)), rtol=1e-6)
    jc, tc = jmech.clip_tree(jt, clip), tmech.clip_tree(tt, clip)
    for k in t:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6, atol=1e-8)


def test_add_gaussian_noise_matches_reference():
    rng = np.random.default_rng(2)
    t = {"w": rng.standard_normal((50, 40)).astype(np.float32),
         "b": np.zeros((7,), np.float32)}
    key = jax.random.fold_in(jax.random.PRNGKey(3), 4)
    tkey = prng.fold_in(prng.PRNGKey(3), 4)
    jn = jmech.add_gaussian_noise({k: jnp.asarray(v) for k, v in t.items()},
                                  key, 0.8)
    tn = tmech.add_gaussian_noise({k: torch.tensor(v) for k, v in t.items()},
                                  tkey, 0.8)
    for k in t:
        want = np.asarray(jn[k])
        n = np.abs(want - t[k]) / 0.8
        tol = (NORMAL_ULP + 2) * EPS * (0.8 * n + np.abs(t[k]))
        assert (np.abs(tn[k].numpy() - want) <= tol + 1e-30).all(), k


def test_noise_is_drawn_for_f32_leaves_only():
    with pytest.raises(TypeError, match="f32"):
        tmech.add_gaussian_noise({"w": torch.zeros(3, dtype=torch.bfloat16)},
                                 prng.PRNGKey(0), 1.0)


@pytest.mark.parametrize("clip", [0.5, 3.0])
def test_clip_accumulate_oracle_matches_reference(clip):
    rng = np.random.default_rng(3)
    t = _grads_tree(rng, 12)
    want = jmech.clip_accumulate(jax.tree_util.tree_map(jnp.asarray, t), clip)
    got = tmech.clip_accumulate(tree.tree_map(torch.tensor, t), clip)
    flat = np.concatenate([l.reshape(12, -1)
                           for l in jax.tree_util.tree_leaves(t)], axis=1)
    terms = _sum_terms(flat, clip)
    w, g = (np.concatenate([np.asarray(l).ravel() for l in
                            jax.tree_util.tree_leaves(x)])
            for x in (want, tree.tree_map(lambda l: l.numpy(), got)))
    assert (np.abs(w - g) <= SUM_RTOL * terms + 1e-30).all()


@pytest.mark.parametrize("N,D,clip", [
    (8, 512, 0.5), (16, 1024, 1.0), (32, 2048, 0.1), (4, 300, 2.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dp_clip_ops_match_reference_ops(N, D, clip, dtype):
    """The port's ``clip_accumulate`` (plain route on the CPU) against the
    reference's ``ops.clip_accumulate`` (Pallas, interpret mode) at the
    reference suite's shapes; bf16 in, f32 out in both."""
    g = (np.random.default_rng(N).standard_normal((N, D)) * 3.0
         ).astype(np.float32)
    jg = jnp.asarray(g).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    tg = torch.tensor(g).to(getattr(torch, dtype))
    want = np.asarray(jclip.clip_accumulate(jg, clip=clip))
    got = tclip.clip_accumulate(tg, clip=clip)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    terms = _sum_terms(_np32(jg), clip)
    assert (np.abs(got.numpy() - want) <= SUM_RTOL * terms + 1e-30).all()


def test_dp_clip_tree_matches_reference_tree():
    """Flattened in jax's leaf order (b1 before w1), clipped, unflattened."""
    rng = np.random.default_rng(4)
    grads = {"w1": rng.standard_normal((8, 16, 16)).astype(np.float32),
             "b1": rng.standard_normal((8, 16)).astype(np.float32)}
    want = jclip.clip_accumulate_tree(
        {k: jnp.asarray(v) for k, v in grads.items()}, clip=0.7)
    got = tclip.clip_accumulate_tree(
        {k: torch.tensor(v) for k, v in grads.items()}, clip=0.7)
    flat = np.concatenate([grads["b1"], grads["w1"].reshape(8, -1)], axis=1)
    terms = _sum_terms(flat, 0.7)
    w = np.concatenate([np.asarray(want["b1"]).ravel(),
                        np.asarray(want["w1"]).ravel()])
    g = np.concatenate([got["b1"].numpy().ravel(), got["w1"].numpy().ravel()])
    assert got["w1"].shape == (16, 16) and got["b1"].shape == (16,)
    assert (np.abs(w - g) <= SUM_RTOL * terms + 1e-30).all()


def test_per_example_loss_grad_matches_jax_at_the_tie():
    """At w = 0 every logit is exactly 0: torch's autograd must take
    jax's derivatives there (balanced maximum, abs' = +1 at 0)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 9)).astype(np.float32)
    y = np.array([0, 1, 1, 0, 1, 0], np.float32)
    jp = {"w": jnp.zeros((9,)), "b": jnp.zeros(())}
    tp = {"w": torch.zeros(9), "b": torch.zeros(())}
    for l2 in (0.0, 0.01):
        jg = jax.vmap(lambda xe, ye: jax.grad(jlogreg.per_example_loss)(
            jp, xe, ye, l2))(jnp.asarray(x), jnp.asarray(y))
        tg = torch.func.vmap(torch.func.grad(tlogreg.per_example_loss),
                             in_dims=(None, 0, 0, None))(
            tp, torch.tensor(x), torch.tensor(y), l2)
        for k in ("w", "b"):
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=1e-6, atol=1e-7)
        jl = jax.vmap(lambda xe, ye: jlogreg.per_example_loss(
            jp, xe, ye, l2))(jnp.asarray(x), jnp.asarray(y))
        tl = torch.stack([tlogreg.per_example_loss(tp, torch.tensor(xe),
                                                   torch.tensor(ye), l2)
                          for xe, ye in zip(x, y)])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)


def _logreg_round(X, y, w0, mb, key_seed):
    jp = {"w": jnp.asarray(w0), "b": jnp.zeros(())}
    tp = {"w": torch.tensor(w0), "b": torch.zeros(())}
    kw = dict(clip_norm=0.1, sigma=8.0, microbatch=mb)
    U1, l1 = jmech.dp_sgd_round(
        lambda p, ex: jlogreg.per_example_loss(p, ex[0], ex[1]), jp,
        (jnp.asarray(X), jnp.asarray(y)), rng=jax.random.PRNGKey(key_seed),
        **kw)
    U2, l2 = tmech.dp_sgd_round(
        lambda p, ex: tlogreg.per_example_loss(p, ex[0], ex[1]), tp,
        (torch.tensor(X), torch.tensor(y)), rng=prng.PRNGKey(key_seed), **kw)
    return U1, l1, U2, l2


@pytest.mark.parametrize("mb", [0, 24, 25])
@pytest.mark.parametrize("w_kind", ["zeros", "random"])
def test_dp_sgd_round_matches_reference(mb, w_kind):
    """The paper's round on logistic regression: per-example grads by
    ``torch.func``, clipped and summed through ``clip_accumulate_tree``
    (whole, or in microbatches of 24; 25 does not divide N, so the round
    runs whole as in the reference), noise through the split key chain.
    """
    rng = np.random.default_rng(6)
    N, d = 96, 20
    X = rng.standard_normal((N, d)).astype(np.float32)
    y = (rng.random(N) < 0.5).astype(np.float32)
    w0 = (np.zeros(d, np.float32) if w_kind == "zeros"
          else 0.3 * rng.standard_normal(d).astype(np.float32))
    U1, l1, U2, l2 = _logreg_round(X, y, w0, mb, 7)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    # sum|terms| from the reference's own per-example gradients
    gs = jax.vmap(lambda xe, ye: jax.grad(jlogreg.per_example_loss)(
        {"w": jnp.asarray(w0), "b": jnp.zeros(())}, xe, ye))(
        jnp.asarray(X), jnp.asarray(y))
    flat = np.concatenate([np.asarray(gs["b"])[:, None],
                           np.asarray(gs["w"])], axis=1)
    terms = _sum_terms(flat, 0.1)
    want = np.concatenate([np.asarray(U1["b"]).reshape(1),
                           np.asarray(U1["w"])])
    got = np.concatenate([U2["b"].numpy().reshape(1), U2["w"].numpy()])
    noise = np.abs(want) / 0.8 + 6.0   # |n| bound from |U| (|clipped sum| <= 9.6)
    tol = SUM_RTOL * terms + (NORMAL_ULP + 2) * EPS * 0.8 * noise
    assert (np.abs(got - want) <= tol).all()


def test_dp_sgd_round_generic_loss_and_microbatch_sum():
    """A loss with one leaf: the microbatched round sums the same clipped
    terms as the whole round (sigma 0), and both match the reference."""
    rng = np.random.default_rng(8)
    X = rng.standard_normal((24, 6)).astype(np.float32)
    y = np.ones((24,), np.float32)

    def jloss(p, ex):
        return jnp.sum((ex[0] @ p["w"] - ex[1]) ** 2)

    def tloss(p, ex):
        return torch.sum((ex[0] @ p["w"] - ex[1]) ** 2)

    outs = []
    for mb in (0, 6):
        U1, _ = jmech.dp_sgd_round(jloss, {"w": jnp.ones((6,)) * 0.1},
                                   (jnp.asarray(X), jnp.asarray(y)),
                                   clip_norm=0.5, sigma=0.0,
                                   rng=jax.random.PRNGKey(3), microbatch=mb)
        U2, _ = tmech.dp_sgd_round(tloss, {"w": torch.ones(6) * 0.1},
                                   (torch.tensor(X), torch.tensor(y)),
                                   clip_norm=0.5, sigma=0.0,
                                   rng=prng.PRNGKey(3), microbatch=mb)
        np.testing.assert_allclose(U2["w"].numpy(), np.asarray(U1["w"]),
                                   rtol=1e-5, atol=1e-6)
        outs.append(U2["w"].numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
