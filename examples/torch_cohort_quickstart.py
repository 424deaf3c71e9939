"""Cohort engine quickstart on the PyTorch port: the same async FL
protocol, three engines.

``examples/cohort_quickstart.py`` through ``repro_torch``: the event
simulator steps one client at a time off a heap; the cohort engine holds
the whole population as ``[C, D]`` blocks and advances every unblocked
client at once each tick; the device engine keeps the whole protocol on
the card, one host read a tick.  With a ``sample_seed`` task all three
give the same trajectory (d = 1), which this example checks before
racing them.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_cohort_quickstart.py [--device cpu]
"""
import argparse
import io
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.cohort import make_simulator
from repro_torch.configs.base import FLConfig
from repro_torch.core import LogRegTask
from repro_torch.data import make_binary_dataset
from repro_torch.scenarios import (LatencyTable, RegionalChurn, Scenario,
                                   TableAssignment)

PRESETS = ("uniform", "mobile_diurnal", "iot_straggler", "geo_regional",
           "sensor_renewal")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' here)")
    ap.add_argument("--n", type=int, default=4_000, help="examples")
    ap.add_argument("--clients", type=int, default=1024,
                    help="population of the throughput race")
    ap.add_argument("--scenario-clients", type=int, default=256,
                    help="population of the scenario runs")
    ap.add_argument("--presets", nargs="+", default=list(PRESETS),
                    choices=PRESETS, help="scenario presets to run")
    return ap.parse_args(argv)


def _w(res):
    return np.asarray(res["model"]["w"].cpu())


def main(argv=None) -> dict:
    args = parse(argv)
    dev = args.device
    X, y = make_binary_dataset(n=args.n, d=32, seed=0, noise=0.3)
    rounds, s, etas = 3, 16, [0.1, 0.08, 0.06]
    out = {}

    def task():
        return LogRegTask(X, y, l2=1.0 / len(X), sample_seed=0)

    # -- agreement on a small cohort (noise off, deterministic sampling) --
    # the engine is an FLConfig knob: same call, any implementation
    kw = dict(sizes_per_client=[s] * rounds, round_stepsizes=etas,
              d=1, seed=0, device=dev)
    res_ev = make_simulator(FLConfig(engine="event"), task(),
                            n_clients=8, **kw).run(max_rounds=rounds)
    res_co = make_simulator(FLConfig(engine="cohort", cohort_block=16),
                            task(), n_clients=8, **kw).run(max_rounds=rounds)
    res_dv = make_simulator(FLConfig(engine="device", cohort_block=16),
                            task(), n_clients=8, **kw).run(max_rounds=rounds)
    dw = np.abs(_w(res_ev) - _w(res_co)).max()
    dw_dev = np.abs(_w(res_co) - _w(res_dv)).max()
    print(f"[parity C=8]    rounds {res_ev['final']['round']} == "
          f"{res_co['final']['round']} == {res_dv['final']['round']}, "
          f"max|dw| = {dw:.2e} (cohort vs device: {dw_dev:.0e})")
    out["parity"] = {"rounds": [int(r["final"]["round"])
                                for r in (res_ev, res_co, res_dv)],
                     "loss": [float(r["final"]["loss"])
                              for r in (res_ev, res_co, res_dv)],
                     "max_dw": float(dw), "max_dw_device": float(dw_dev)}

    # -- throughput at a population the event engine can't hold ----------
    C = args.clients
    for engine in ("cohort", "device"):
        t0 = time.time()
        res = make_simulator(FLConfig(engine=engine), task(),
                             n_clients=C, **kw).run(max_rounds=rounds)
        dt = time.time() - t0
        print(f"[{engine} C={C}] rounds={res['final']['round']} "
              f"acc={res['final']['accuracy']:.4f} "
              f"({C * rounds / dt:,.0f} client-rounds/sec)")
        out[engine] = {"rounds": int(res["final"]["round"]),
                       "messages": int(res["final"]["messages"]),
                       "accuracy": float(res["final"]["accuracy"]),
                       "loss": float(res["final"]["loss"])}

    # -- fleet-heterogeneity scenarios (repro_torch.scenarios) -----------
    # one FLConfig knob swaps the whole network model: empirical latency
    # table, availability windows/churn, drawn fleet speeds.  Virtual
    # completion time shows what stragglers and off-windows cost.
    C = args.scenario_clients
    out["scenarios"] = {}
    for preset in args.presets:
        res = make_simulator(
            FLConfig(engine="device", cohort_block=16, scenario=preset),
            task(), n_clients=C, **kw).run(max_rounds=rounds)
        print(f"[scenario {preset:>15} C={C}] "
              f"rounds={res['final']['round']} "
              f"virtual_time={res['final']['time']:,.0f}s "
              f"messages={res['final']['messages']}")
        out["scenarios"][preset] = {
            "rounds": int(res["final"]["round"]),
            "messages": int(res["final"]["messages"]),
            "time": float(res["final"]["time"]),
            "loss": float(res["final"]["loss"])}

    # -- heterogeneity v2: per-client tables + correlated churn ----------
    # two network populations assigned per client and regional outages
    # sharing a per-(epoch, region) factor
    scn = Scenario(
        "two_pop_regional",
        (LatencyTable.from_lognormal(median=0.08, sigma=0.4, n_bins=8),
         LatencyTable.from_pareto(scale=0.2, alpha=1.3, n_bins=8)),
        RegionalChurn(n_regions=4, p_available=0.9, p_region_up=0.95),
        assignment=TableAssignment("draw", weights=(0.7, 0.3)))
    res = make_simulator(
        FLConfig(engine="device", cohort_block=16, scenario=scn),
        task(), n_clients=C, **kw).run(max_rounds=rounds)
    print(f"[scenario {scn.name} C={C}] rounds={res['final']['round']} "
          f"virtual_time={res['final']['time']:,.0f}s "
          f"messages={res['final']['messages']}")
    out["scenarios"][scn.name] = {
        "rounds": int(res["final"]["round"]),
        "messages": int(res["final"]["messages"]),
        "time": float(res["final"]["time"]),
        "loss": float(res["final"]["loss"])}

    # -- telemetry: every run() returns a MetricsReport with the
    # communication census, the staleness-at-apply histogram, the far
    # tier's high-water mark and, with DP noise, per-client accounting
    tel = res["telemetry"]
    print("[telemetry]")
    print(tel.summary())
    out["telemetry"] = {"messages": int(tel.messages),
                        "staleness_hist": [int(x)
                                           for x in tel.staleness_hist]}

    # the event simulator can also stream a JSONL trace of every send /
    # apply / broadcast (kind + round + client + staleness):
    buf = io.StringIO()
    make_simulator(FLConfig(engine="event"), task(), n_clients=8,
                   trace=buf, **kw).run(max_rounds=rounds)
    lines = buf.getvalue().splitlines()
    print(f"[trace] {len(lines)} JSONL records; first: {lines[0]}")
    out["trace_records"] = len(lines)
    return out


if __name__ == "__main__":
    main()
