"""The whole slice: the port's DeviceCohortSimulator (on the CPU, i.e. on
the plain kernel versions) against the live JAX reference engine.

Integer fields — rounds, messages, broadcasts, participation, bytes,
the staleness histogram, the op census and the loop-iteration census —
are exact.  Losses and the final model are held to the goldens'
rtol 1e-5 / atol 1e-7 (measured: <= 1.5e-7 relative on the losses,
<= 2.4e-7 absolute on the model).  The goldens themselves are not used:
they were recorded on an older jax and no longer reproduce; the
reference is run live instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cohort import DeviceCohortSimulator as JaxSimulator
from repro.core import LogRegTask as JaxLogRegTask
from repro_torch import DeviceCohortSimulator, LogRegTask
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.data import make_binary_dataset

RTOL, ATOL = 1e-5, 1e-7

# the golden `uniform` case (tests/test_golden_trajectories.py)
GOLDEN = dict(data=(300, 12, 9), task=dict(l2=1.0 / 300, sample_seed=21),
              sim=dict(n_clients=6, sizes_per_client=[4, 6, 8],
                       round_stepsizes=[0.1, 0.08, 0.06], d=2, seed=2,
                       block=4, scenario="uniform"),
              rounds=3, eval_every=1)
GOLDEN_DP = dict(GOLDEN, task=dict(GOLDEN["task"], dp_clip=0.1,
                                   dp_sigma=8.0),
                 sim=dict(GOLDEN["sim"], dp_round_clip=1.0))
# fedsgd_r8_s1 of benchmarks/bench_cohort_scale.py at C = 64
FEDSGD = dict(data=(2048, 32, 0), task=dict(l2=1.0 / 2048, sample_seed=0),
              sim=dict(n_clients=64, sizes_per_client=[1] * 8,
                       round_stepsizes=[0.1] * 8, d=1, seed=0, block=64),
              rounds=8, eval_every=8)
CASES = {"golden_uniform": GOLDEN, "golden_uniform_dp": GOLDEN_DP,
         "fedsgd_r8_s1_C64": FEDSGD}


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _run(cfg, jax_side: bool):
    n, d, seed = cfg["data"]
    X, y = make_binary_dataset(n, d, seed=seed, noise=0.3)
    if jax_side:
        sim = JaxSimulator(JaxLogRegTask(X, y, **cfg["task"]), **cfg["sim"])
    else:
        sim = DeviceCohortSimulator(LogRegTask(X, y, **cfg["task"]),
                                    **cfg["sim"], device="cpu")
    res = sim.run(max_rounds=cfg["rounds"], eval_every=cfg["eval_every"])
    tel = res["telemetry"]
    return {
        "ints": {
            "rounds": int(res["final"]["round"]),
            "messages": int(res["final"]["messages"]),
            "broadcasts": int(res["final"]["broadcasts"]),
            "participation": [int(x) for x in tel.participation],
            "bytes_up": int(tel.bytes_up.sum()),
            "staleness_hist": [int(x) for x in tel.staleness_hist],
            "ops": dict(tel.ops),
            "ticks": int(tel.ticks),
            "fused_iters": tuple(sim.engine.fused_iters),
        },
        "losses": [float(h["loss"]) for h in res["history"]]
        + [float(res["final"]["loss"])],
        "model": np.concatenate([_np(res["model"]["w"]).ravel(),
                                 _np(res["model"]["b"]).reshape(1)]),
        "dp": tel.dp,
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_matches_reference(case):
    want = _run(CASES[case], jax_side=True)
    got = _run(CASES[case], jax_side=False)
    assert got["ints"] == want["ints"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["model"], want["model"], rtol=RTOL,
                               atol=ATOL)
    assert got["dp"] == want["dp"]


def test_one_tick_from_the_same_state():
    """Run the reference a few ticks, carry its state across, and advance
    both engines tick by tick from the same state (DP on, so completion
    ticks clip and noise)."""
    cfg = GOLDEN_DP
    n, d, seed = cfg["data"]
    X, y = make_binary_dataset(n, d, seed=seed, noise=0.3)
    jsim = JaxSimulator(JaxLogRegTask(X, y, **cfg["task"]), **cfg["sim"],
                        fuse_ticks=False)
    tsim = DeviceCohortSimulator(LogRegTask(X, y, **cfg["task"]),
                                 **cfg["sim"], fuse_ticks=False,
                                 device="cpu")
    je, te = jsim.engine, tsim.engine
    seg = je._segment_fn()
    st = je.state
    for t in range(1, 9):
        np_state = jax.tree_util.tree_map(np.asarray, st)
        te.state = state_from_jax(np_state)
        te.segment(target_k=99, tick_limit=t)
        st = seg(st, je._etas_dev, je._sizes_dev, je._accrual_dev,
                 jnp.int32(99), jnp.int32(t))
        for f in st._fields:
            a, b = np.asarray(getattr(st, f)), _np(getattr(te.state, f))
            assert a.shape == b.shape and a.dtype == b.dtype, f
            if a.dtype == np.int32:
                assert np.array_equal(a, b), (t, f)
            else:
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                           err_msg=f"tick {t} field {f}")
    assert int(st.messages) > 0 and int(st.server_k) > 0


def test_params_from_jax_carries_the_init_model():
    X, y = make_binary_dataset(50, 6, seed=0)
    jp = JaxLogRegTask(X, y).init_model()
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    assert np.array_equal(tp["w"].numpy(), np.asarray(jp["w"]))
    assert tp["b"].shape == () and tp["b"].dtype == torch.float32
    # the port's own init draws the same normals within the normal()
    # ulp bound (test_torch_prng.py)
    own = LogRegTask(X, y).init_model()["w"].numpy()
    np.testing.assert_allclose(own, np.asarray(jp["w"]), rtol=1e-6,
                               atol=1e-9)


def test_unported_options_raise_with_their_roadmap_item():
    X, y = make_binary_dataset(50, 6, seed=0)
    task = LogRegTask(X, y, sample_seed=0)
    kw = dict(n_clients=4, sizes_per_client=[2], round_stepsizes=[0.1],
              device="cpu")
    for extra in (dict(strategy="fedasync"), dict(scenario="iot_straggler"),
                  dict(dp_rng="in_kernel"), dict(block=4, latency=(0.5, 9.0))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DeviceCohortSimulator(task, **kw, **extra)
