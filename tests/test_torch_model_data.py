"""The port's federated data layer, ``prng.permutation`` and the
coordinate masks against the live reference, bit for bit: the
seed-addressed and host-side batchers, ``client_sample_sizes``, jax's
sort-based permutation and ``make_partition`` (twins of
``tests/test_ordering_masks.py``'s partition tests among them)."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.data as JD
from repro.core import masks as jmasks
from repro.models import init_params as j_init_params
from repro_torch import convert, prng, tree
from repro_torch.configs import get_config, reduced
from repro_torch.core import masks as tmasks
from repro_torch.data import (FederatedBatcher, SeedAddressedBatcher,
                              client_sample_sizes)


# --- data -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-780m"])
def test_seed_addressed_batches_bitwise(arch):
    jcfg, tcfg = JC.get_config(arch), get_config(arch)
    jb = JD.SeedAddressedBatcher(jcfg, batch_size=3, seq_len=40, seed=7)
    tb = SeedAddressedBatcher(tcfg, batch_size=3, seq_len=40, seed=7,
                              device="cpu")
    for c, i, h in ((0, 0, 0), (2, 5, 3), (7, 1, 11)):
        jt = np.asarray(jb(c, i, h)["tokens"])
        tt = tb(c, i, h)["tokens"]
        assert tt.dtype == torch.int32 and np.array_equal(tt.numpy(), jt)
        # the cohort block's path: the key chain on tensors
        key = prng.fold_in(prng.fold_in(prng.fold_in(
            tb.base, torch.tensor(c)), torch.tensor(i)), torch.tensor(h))
        assert torch.equal(tb.batch_from_key(key)["tokens"], tt)
    with pytest.raises(ValueError, match="decoder families"):
        SeedAddressedBatcher(get_config("whisper-large-v3"), batch_size=1,
                             seq_len=4, device="cpu")


def test_federated_batches_and_sample_sizes_bitwise():
    jcfg = JC.reduced(JC.get_config("gemma-2b"))
    tcfg = reduced(get_config("gemma-2b"))
    jb = JD.FederatedBatcher(jcfg, batch_size=2, seq_len=9, seed=1)
    tb = FederatedBatcher(tcfg, batch_size=2, seq_len=9, seed=1,
                          device="cpu")
    assert np.array_equal(tb(1, 2, 3)["tokens"].numpy(),
                          np.asarray(jb(1, 2, 3)["tokens"]))
    jg, tg = jb.global_batch(3, 4), tb.global_batch(3, 4)
    assert tg["tokens"].shape == (3, 2, 9)
    assert np.array_equal(tg["tokens"].numpy(), np.asarray(jg["tokens"]))
    sizes, p = [100] * 20, [0.5, 0.3, 0.2]
    for exact in (False, True):
        assert client_sample_sizes(sizes, p, seed=4, exact=exact) == \
            JD.client_sample_sizes(sizes, p, seed=4, exact=exact)


# --- permutation and masks --------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 1000, 70000])
def test_permutation_bitwise(n):
    for seed in (0, 5):
        jp = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        tp = prng.permutation(prng.PRNGKey(seed), n)
        assert np.array_equal(tp.numpy(), jp)


def test_make_partition_bitwise_on_model_params():
    jcfg = JC.reduced(JC.get_config("gemma-2b"), n_layers=1, d_model=32,
                      vocab=64)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0), jax.numpy.float32)
    tp = convert.model_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jp),
                                       device="cpu")
    for D, seed in ((4, 0), (7, 3)):
        jpart = jmasks.make_partition(jp, D, seed=seed)
        tpart = tmasks.make_partition(tp, D, seed=seed)
        for a, b in zip(jax.tree_util.tree_leaves(jpart),
                        tree.leaves(tpart)):
            assert b.dtype == torch.int32
            assert np.array_equal(b.numpy(), np.asarray(a))


def test_partition_balanced_and_complete():
    params = {"w": torch.zeros((13, 7)), "b": torch.zeros((5,))}
    D = 4
    part = tmasks.make_partition(params, D, seed=0)
    for leaf in tree.leaves(part):
        assert int(leaf.min()) >= 0 and int(leaf.max()) < D
    # every coordinate in exactly one group
    total = sum(int(tmasks.mask_for_group(part, u)["w"].sum())
                for u in range(D))
    assert total == 13 * 7


def test_masked_update_unbiased():
    """Equation (10): d_ξ E[S_u] = I  =>  E_u[masked update] == grad, and
    the reference's masked updates on the same gradient."""
    key = jax.random.PRNGKey(0)
    jgrad = {"w": jax.random.normal(key, (32, 8)),
             "b": jax.random.normal(jax.random.fold_in(key, 1), (8,))}
    grad = {k: torch.tensor(np.asarray(v)) for k, v in jgrad.items()}
    D = 4
    part = tmasks.make_partition(grad, D, seed=1)
    recon = tmasks.expectation_check(grad, part, D)
    np.testing.assert_allclose(recon["w"].numpy(), grad["w"].numpy(),
                               rtol=1e-5)
    jpart = jmasks.make_partition(jgrad, D, seed=1)
    for u in range(D):
        a = tmasks.apply_masked_update(grad, part, u, D)
        b = jmasks.apply_masked_update(jgrad, jpart, u, D)
        for k in ("w", "b"):
            assert np.array_equal(a[k].numpy(), np.asarray(b[k]))


def test_masked_update_reduces_communication():
    grad = {"w": torch.ones((1000,), dtype=torch.float32)}
    D = 10
    part = tmasks.make_partition(grad, D, seed=0)
    upd = tmasks.apply_masked_update(grad, part, 0, D)
    nbytes = tmasks.masked_update_nbytes(upd, part, 0)
    assert nbytes == 100 * 4          # 1/D of the dense 4000 bytes
