"""The harness's contract on the CPU: the result line's shape, a cell,
configuration, traffic or per-layer metric added by files and
BENCHMARK.json entries alone, no result without a card, and no import
of JAX or the JAX package."""
import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap

from _small import LOGREG, ROOT, run

FEDBENCH = ROOT / "fedbench"


def test_result_line_shape():
    res, _ = run("logreg_fig1b_dp", LOGREG)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "compared"        # the numbers compared, last
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"]: m["unit"] for m in spec["end_to_end"]
            if "logreg_fig1b_dp" in m.get("workloads", ["logreg_fig1b_dp"])}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert all(v["value"] > 0 for k, v in res["metrics"].items()
               if k != "peak_mem_gib")          # no card, no device memory
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_new_cell_config_traffic_and_metric_by_files_alone(tmp_path):
    """In a copy: a new configuration file, traffic file and metric
    module and their BENCHMARK.json entries; no file that was there is
    edited.  The harness finds them by name and reports the metric."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(FEDBENCH, tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "fedbench").rglob("*")
              if p.is_file()}
    cfg = json.loads((FEDBENCH / "configs" /
                      "paper_logreg_d785.json").read_text())
    cfg.update(name="paper_logreg_d24", d_features=24, n_examples=300)
    (tmp_path / "fedbench/configs/paper_logreg_d24.json").write_text(
        json.dumps(cfg))
    traf = json.loads((FEDBENCH / "traffic/fig1b_dp.json").read_text())
    traf.update(LOGREG["traffic"], why="a small population")
    (tmp_path / "fedbench/traffic/small.json").write_text(json.dumps(traf))
    (tmp_path / "fedbench/metrics/ticks_in_window.py").write_text(
        textwrap.dedent('''\
        """Protocol ticks the window ran."""
        UNIT = "ticks"
        PROBES = ()


        def read(ctx):
            return ctx["census"]["ticks"]
        '''))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(
        name="paper_logreg_d24", source="arXiv:2007.09208",
        file="fedbench/configs/paper_logreg_d24.json", reduced=[],
        why="small"))
    spec["workloads"].append(dict(name="tiny", config="paper_logreg_d24",
                                  traffic="small", chips=1, why="small"))
    spec["per_layer"].append(dict(
        name="ticks_in_window", unit="ticks", better="higher",
        source="program_counter", layer="segment loop",
        moves="client_steps_per_s", workloads=["tiny"]))
    for m in spec["per_layer"][:-1]:     # the card's probes: not here
        m["workloads"] = []
    spec["end_to_end"][0]["workloads"].append("tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = textwrap.dedent(f'''\
        import json, sys, time
        sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / "src")!r}]
        from fedbench import harness
        assert harness.__file__.startswith({str(tmp_path)!r})
        res, found = harness.run_cell("tiny", 3, 0.2, True,
                                      t_start=time.perf_counter(),
                                      device="cpu")
        print(json.dumps(dict(res, found=found)))
        ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["found"] == []        # the port's run loads no JAX
    assert res["metrics"]["ticks_in_window"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_no_result_without_a_card():
    out = subprocess.run(
        [sys.executable, str(FEDBENCH / "run.py"), "--workload",
         "logreg_fig1b_dp", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert not any(line.startswith("{")
                   for line in out.stdout.splitlines())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_jax_and_a_reference_of_its_own():
    """No module of the benchmark imports JAX or the JAX package (the
    top-level name compared whole: the port's name begins with it), and
    the reference imports nothing of the program."""
    for path in FEDBENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path
