"""The port's threefry mirror (repro_torch.prng) against live jax.

Keys, fold_in, raw bits, uniform and the sample-index chain are bitwise.
``normal`` goes through ``erf_inv``: the port evaluates XLA's f32
polynomial with PyTorch's ``log1p`` and separate multiply/add, where XLA
on the CPU uses its own ``log1p`` and fused multiply-adds; measured gap
<= 3 ulp (2 from erf_inv, 1 more from the sqrt(2) scale), bound 4 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.analysis.salts import NOISE_SALT
from repro_torch.core import LogRegTask

NORMAL_ULP = 4


def _np(key):
    return np.asarray(key).astype(np.int64)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# past 32 bits and below 0, jax (jax_enable_x64=False) keeps the low
# word with a zero high word
@pytest.mark.parametrize("seed", [0, 1, 2, 21, 2 ^ NOISE_SALT, 2 ** 31 - 1,
                                  2 ** 32, 2 ** 32 + 5, 2 ** 40 + 7,
                                  12345678901, -1, -5, 2 ** 63 - 1,
                                  -2 ** 63])
def test_prng_key_bitwise(seed):
    assert (_np(jax.random.PRNGKey(seed))
            == prng.PRNGKey(seed).numpy()).all()


@pytest.mark.parametrize("seed", [2 ** 64, 2 ** 63, -2 ** 63 - 1])
def test_prng_key_outside_int64_raises_like_jax(seed):
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(seed)
    with pytest.raises(OverflowError):
        prng.PRNGKey(seed)


def test_noise_root_key_words():
    # the DP chain's root for seed 2: [0, 2 ^ 0x5EED]
    assert prng.PRNGKey(2 ^ NOISE_SALT).tolist() == [0, 24303]


@pytest.mark.parametrize("data", [0, 1, 5, 12345678, 2 ** 31 - 1,
                                  2 ** 32 - 1])
def test_fold_in_scalar_bitwise(data):
    k = jax.random.PRNGKey(7)
    want = _np(jax.random.fold_in(k, np.uint32(data)))
    got = prng.fold_in(prng.PRNGKey(7), data).numpy()
    assert (want == got).all()


@pytest.mark.parametrize("data", [-1, 2 ** 32, 2 ** 32 + 3])
def test_fold_in_int_outside_uint32_raises_like_jax(data):
    with pytest.raises(OverflowError):
        jax.random.fold_in(jax.random.PRNGKey(7), data)
    with pytest.raises(OverflowError):
        prng.fold_in(prng.PRNGKey(7), data)


def test_fold_in_batched_bitwise():
    k = jax.random.PRNGKey(11)
    keys = jax.vmap(lambda c: jax.random.fold_in(k, c))(jnp.arange(257))
    got = prng.fold_in(prng.PRNGKey(11), torch.arange(257))
    assert (_np(keys) == got.numpy()).all()
    # a batch of keys folded with a batch of data
    data = np.arange(257) * 7 + 3
    want = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(data))
    got2 = prng.fold_in(got, torch.as_tensor(data))
    assert (_np(want) == got2.numpy()).all()


@pytest.mark.parametrize("shape", [(64, 33), (7,), (3, 5, 2)])
def test_bits_and_uniform_bitwise(shape):
    k = jax.random.fold_in(jax.random.PRNGKey(3), 9)
    tk = prng.fold_in(prng.PRNGKey(3), 9)
    assert (_np(jax.random.bits(k, shape))
            == prng.random_bits(tk, shape).numpy()).all()
    u = np.asarray(jax.random.uniform(k, shape))
    assert (_ulps(u, prng.uniform(tk, shape).numpy()) == 0).all()
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u2 = np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=1.0))
    assert (_ulps(u2, prng.uniform(tk, shape, float(lo), 1.0).numpy())
            == 0).all()


@pytest.mark.parametrize("lo,hi", [(-2.0, 3.0), (0.1, 0.3), (1.0, 5.0),
                                   (0.0, 1.0), (-1e-3, 7.5)])
def test_uniform_on_a_range_bitwise(lo, hi):
    """``f * (hi - lo) + lo`` rounds once, as XLA's fused multiply-add:
    over 100000 draws every bit agrees."""
    n = 100_000
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (n,),
                                         minval=lo, maxval=hi))
    got = prng.uniform(prng.PRNGKey(3), (n,), lo, hi).numpy()
    assert got.dtype == np.float32
    assert (_ulps(want, got) == 0).all()


@pytest.mark.parametrize("tick", [1, 2, 17, 1000])
def test_normal_noise_chain_within_ulp_bound(tick):
    seed = 2
    k = jax.random.fold_in(jax.random.PRNGKey(seed ^ NOISE_SALT), tick)
    want = np.asarray(jax.random.normal(k, (64, 33), jnp.float32))
    tk = prng.fold_in(prng.PRNGKey(seed ^ NOISE_SALT), tick)
    got = prng.normal(tk, (64, 33)).numpy()
    assert _ulps(want, got).max() <= NORMAL_ULP
    assert np.isfinite(got).all()


@pytest.mark.parametrize("slab", [None, 64])
@pytest.mark.parametrize("lo,hi", [(0, 64), (0, 1), (7, 8), (13, 41),
                                   (63, 64), (20, 20)])
def test_normal_rows_is_the_matching_slice_of_the_whole_draw(
        monkeypatch, slab, lo, hi):
    """A rank's rows of the noise draw: ``normal_rows`` bit for bit the
    rows of ``normal`` over the whole client axis, with the slab of 64
    elements (two rows of 33) cutting rows and ranges too."""
    if slab is not None:
        monkeypatch.setattr(prng, "NORMAL_SLAB", slab)
    key = prng.fold_in(prng.PRNGKey(2 ^ NOISE_SALT), 17)
    whole = prng.normal(key, (64, 33))
    rows = prng.normal_rows(key, (64, 33), lo, hi)
    assert rows.shape == (hi - lo, 33)
    assert torch.equal(rows.view(torch.int32), whole[lo:hi].view(torch.int32))


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, -0.5, 0.5])
    out = prng.erf_inv(x)
    assert out[0] == -float("inf") and out[1] == float("inf")
    assert out[2] == 0.0 and out[3] == -out[4]


def test_cohort_sample_idx_matches_reference_derivation():
    """The cohort task's [C, block] draw, against the reference's vmapped
    fold_in chain (repro/cohort/tasks.py sample_idx)."""
    from repro_torch.cohort.tasks import CohortLogRegTask
    n, C, block = 300, 9, 8
    X = np.zeros((n, 4), np.float32)
    tt = CohortLogRegTask(LogRegTask(X, np.zeros(n, np.float32),
                                     sample_seed=5), C, device="cpu")
    rng = np.random.default_rng(0)
    i = rng.integers(0, 50, C).astype(np.int32)
    h = rng.integers(0, 200, C).astype(np.int32)
    base = jax.random.PRNGKey(5)
    base_keys = jax.vmap(lambda c: jax.random.fold_in(base, c))(
        jnp.arange(C))
    rk = jax.vmap(jax.random.fold_in)(base_keys, jnp.asarray(i))

    def one(rk_c, h_c):
        ks = jax.vmap(lambda j: jax.random.fold_in(rk_c, h_c + j))(
            jnp.arange(block))
        return (ks[:, 0] % jnp.uint32(n)).astype(jnp.int32)

    want = np.asarray(jax.vmap(one)(rk, jnp.asarray(h)))
    got = tt.sample_idx(torch.as_tensor(i), torch.as_tensor(h), block)
    assert (want == got.numpy()).all()


@pytest.mark.parametrize("shape", [(), (2,), (25,)])
def test_batched_key_uniforms_bitwise(shape):
    """``keys_uniform`` on an [N, 2] batch of keys: the reference's
    ``jax.vmap(lambda k: jax.random.uniform(k, shape))(keys)`` (the
    latency-table draws, the renewal holdings, the table ids)."""
    base = jax.random.PRNGKey(0x1A7E9C)
    keys = jax.vmap(lambda c: jax.random.fold_in(base, c))(jnp.arange(300))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))
    tkeys = prng.fold_in(prng.PRNGKey(0x1A7E9C)[None, :], torch.arange(300))
    got = prng.keys_uniform(tkeys, shape).numpy()
    assert got.shape == want.shape
    assert (_ulps(want, got) == 0).all()
    bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape))(keys))
    assert (bits.astype(np.int64) == prng.keys_bits(tkeys, shape).numpy()
            ).all()


@pytest.mark.parametrize("n", [1, 5, 16, 17, 24, 40, 256])
def test_cumsum_xla_matches_jnp_cumsum(n):
    rng = np.random.default_rng(n)
    x = (rng.exponential(size=(37, n)) * 30.0).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    got = prng.cumsum_xla(torch.as_tensor(x)).numpy()
    assert (_ulps(want, got) == 0).all()


@pytest.mark.parametrize("seed,num", [(0, 2), (42, 4), (7, 1),
                                      (2 ** 31 - 1, 9), (3, 300)])
def test_split_bitwise(seed, num):
    """``prng.split`` is ``jax.random.split`` under the live config
    (partitionable: key i hashes the flat index i)."""
    want = _np(jax.random.split(jax.random.PRNGKey(seed), num))
    got = prng.split(prng.PRNGKey(seed), num).numpy()
    assert got.shape == (num, 2)
    assert (want == got).all()


def test_split_chain_bitwise():
    """Split keys of a folded key, split again, then drawn from: the
    chain ``add_gaussian_noise`` runs on a round key."""
    k = jax.random.fold_in(jax.random.PRNGKey(5), 11)
    tk = prng.fold_in(prng.PRNGKey(5), 11)
    ks, tks = jax.random.split(k, 3), prng.split(tk, 3)
    for i in range(3):
        sub, tsub = jax.random.split(ks[i]), prng.split(tks[i])
        assert (_np(sub) == tsub.numpy()).all()
        u = np.asarray(jax.random.uniform(sub[1], (17,)))
        assert (_ulps(u, prng.uniform(tsub[1], (17,)).numpy()) == 0).all()


SEED_PAST_32_BITS = 2 ** 32 + 5


@pytest.mark.parametrize("name", ["mobile_diurnal", "iot_straggler",
                                  "sensor_renewal"])
def test_streams_at_a_seed_past_32_bits(name):
    """Seed 2**32 + 5 keys every stream by its low word, as the
    reference does: the scenario plan's table ids, update and broadcast
    ticks and availability masks, and the device engine's DP noise key
    chain."""
    from repro import scenarios as J
    from repro.scenarios import registry as jreg
    from repro_torch import scenarios as T
    from repro_torch.cohort import DeviceCohortSimulator
    seed, C = SEED_PAST_32_BITS, 64
    jp = jreg.ScenarioPlan(J.get_scenario(name), C=C, seed=seed, dt=0.7)
    tp = T.ScenarioPlan(T.get_scenario(name), C=C, seed=seed, dt=0.7,
                        device="cpu")
    assert np.array_equal(jp.table_id, tp.table_id)
    for r in (0, 3):
        i = np.full(C, r, np.int32)
        assert np.array_equal(jp.host_update_ticks(i),
                              tp.update_ticks(torch.as_tensor(i)).numpy())
    for k in (0, 7):
        assert np.array_equal(jp.host_broadcast_ticks(k),
                              tp.broadcast_ticks(k).numpy())
    if jp.avail_mask is not None:
        for t in (0, 500, 2049):
            assert np.array_equal(jp.host_avail(t), tp.avail_mask(t).numpy())
    X = np.zeros((40, 3), np.float32)
    sim = DeviceCohortSimulator(
        LogRegTask(X, np.zeros(40, np.float32), dp_clip=0.1, dp_sigma=1.0),
        n_clients=4, sizes_per_client=[2, 2], round_stepsizes=[0.1, 0.1],
        d=1, seed=seed, device="cpu")
    base = jax.random.PRNGKey(seed ^ NOISE_SALT)
    assert (_np(base) == sim.engine._noise_base.numpy()).all()
    for t in (1, 17):
        assert (_np(jax.random.fold_in(base, t))
                == prng.fold_in(sim.engine._noise_base, t).numpy()).all()


@pytest.mark.parametrize("lo,hi", [(0, 60000), (0, 1000), (0, 1 << 20),
                                   (-7, 13), (5, 5), (9, 2),
                                   (-2 ** 31, 2 ** 31 - 1), (0, 3)])
def test_randint_vmapped_keys_bitwise(lo, hi):
    """``vmap(randint(k, (), lo, hi))`` over 100000 split keys (the event
    engine's non-``sample_seed`` draw), bit for bit: spans that are and
    are not powers of two, ``maxval = 60000`` (MNIST's n), an empty range
    and the whole int32 range."""
    n = 100_000
    keys = jax.random.split(jax.random.PRNGKey(17), n)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (), lo, hi))(keys))
    got = prng.randint(prng.split(prng.PRNGKey(17), n), (), lo, hi)
    assert want.dtype == np.int32
    assert np.array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("shape", [(7,), (3, 5), ()])
def test_randint_one_key_with_a_shape_bitwise(shape):
    k = jax.random.fold_in(jax.random.PRNGKey(4), 3)
    tk = prng.fold_in(prng.PRNGKey(4), 3)
    for lo, hi in ((0, 60000), (-3, 100), (0, 16)):
        want = np.asarray(jax.random.randint(k, shape, lo, hi))
        assert np.array_equal(want.astype(np.int64),
                              prng.randint(tk, shape, lo, hi).numpy())
