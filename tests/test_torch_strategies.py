"""The port's aggregation strategies (repro_torch.core.strategies) against
the live JAX reference (repro.core.strategies): resolution, the decay
weights bitwise, and FedAsync / FedBuff through the whole device engine
on the reference's zoo cases (integers exact, floats within the goldens'
rtol 1e-5 / atol 1e-7)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import strategies as JS
from repro_torch.core import strategies as TS
from test_torch_device_engine import RTOL, ATOL, _run

DECAYS = [dict(decay="poly"), dict(decay="hinge"), dict(decay="constant"),
          dict(decay="hinge", hinge_a=3.0, hinge_b=1, alpha=0.3),
          dict(decay="poly", poly_a=1.5, alpha=0.9)]


@pytest.mark.parametrize("kw", DECAYS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_decay_weights_and_ring_decay_bitwise(kw):
    js, ts = JS.FedAsyncStrategy(**kw), TS.FedAsyncStrategy(**kw)
    tau = np.arange(16, dtype=np.int32)
    want = np.asarray(js.decay_weights(jnp.asarray(tau)))
    got = ts.decay_weights(torch.as_tensor(tau))
    assert got.dtype == torch.float32
    assert np.array_equal(want.view(np.int32), got.numpy().view(np.int32))
    for R in (4, 8):
        for sk in range(2 * R + 3):
            want = np.asarray(JS.ring_decay(js, jnp.int32(sk), R))
            got = TS.ring_decay(ts, sk, R).numpy()
            assert np.array_equal(want.view(np.int32), got.view(np.int32))
    assert js.fingerprint() == ts.fingerprint()


@pytest.mark.parametrize("spec", [None, "paper", "fedasync", "fedbuff",
                                  {"kind": "fedasync", "alpha": 0.3},
                                  {"kind": "fedbuff", "buffer_size": 7}])
def test_get_strategy_resolves_like_the_reference(spec):
    js, ts = JS.get_strategy(spec), TS.get_strategy(spec)
    assert js.fingerprint() == ts.fingerprint()
    assert (js.stratified, js.buffered) == (ts.stratified, ts.buffered)


def test_strategy_validation():
    with pytest.raises(ValueError):
        TS.FedAsyncStrategy(decay="nope")
    with pytest.raises(ValueError):
        TS.FedBuffStrategy(buffer_size=0)
    with pytest.raises(ValueError):
        TS.get_strategy("fedzoo")
    with pytest.raises(TypeError):
        TS.get_strategy(3)


# the reference's zoo cases (tests/test_strategies.py)
_ZOO = dict(data=(300, 12, 9), task=dict(l2=1.0 / 300, sample_seed=21),
            sim=dict(n_clients=5, sizes_per_client=[4, 6, 8],
                     round_stepsizes=[0.1, 0.08, 0.06], d=2, seed=3,
                     block=4, speeds=[1.0, 0.6, 1.4, 0.8, 1.1]),
            rounds=3, eval_every=1)
ZOO = [None, "fedasync", {"kind": "fedasync", "decay": "hinge"},
       {"kind": "fedasync", "decay": "constant"},
       {"kind": "fedbuff", "buffer_size": 3}]
_IDS = ["paper", "fedasync-poly", "fedasync-hinge", "fedasync-const",
        "fedbuff3"]


def _with(cfg, task=None, **sim):
    return dict(cfg, task=dict(cfg["task"], **(task or {})),
                sim=dict(cfg["sim"], **sim))


def _check(cfg):
    want = _run(cfg, jax_side=True)
    got = _run(cfg, jax_side=False)
    assert got["ints"] == want["ints"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["model"], want["model"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("spec", ZOO, ids=_IDS)
def test_zoo_matches_reference(spec):
    _check(_with(_ZOO, strategy=spec))


@pytest.mark.parametrize("spec,scenario", [
    ("fedasync", "mobile_diurnal"),
    ({"kind": "fedbuff", "buffer_size": 3}, "iot_straggler"),
], ids=["fedasync+dp+diurnal", "fedbuff+dp+straggler"])
def test_zoo_with_dp_and_stochastic_preset_matches_reference(spec,
                                                             scenario):
    _check(_with(_ZOO, task=dict(dp_clip=0.1, dp_sigma=2.0), strategy=spec,
                 scenario=scenario, dp_round_clip=0.5))


@pytest.mark.parametrize("kw", DECAYS + [
    dict(decay="hinge", alpha=0.45, hinge_a=2.5, hinge_b=3),
    dict(decay="poly", alpha=0.75, poly_a=0.8),
    dict(decay="constant", alpha=0.2)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_fedasync_weight_matches_reference(kw):
    """The event server's per-update weight ``alpha * s(tau)``, tau clamped
    at 0, equals the reference's for tau = -2 .. 64."""
    js, ts = JS.FedAsyncStrategy(**kw), TS.FedAsyncStrategy(**kw)
    for tau in range(-2, 65):
        assert ts.weight(tau) == js.weight(tau), tau
    assert TS.PaperStrategy().weight(5) == JS.PaperStrategy().weight(5)
