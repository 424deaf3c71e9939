"""The port's static-analysis pass (``repro_torch.analysis``) against
the reference's (``repro.analysis``).

Twins of ``tests/test_analysis.py``'s registry, PRNG-* and
PRNG-FOLDIN-* cases: each snippet of the reference's tests, respelled
for the port (``prng.PRNGKey`` / ``prng.fold_in``, the port's batched
``fold_in(key[None, :], addrs)`` for ``vmap(fold_in)``,
``repro_torch.analysis.salts``), fires the same rules under the port's
lint as the original under the reference's.  The registry's values and
chains equal the reference's; STRUCT-DTYPE reads torch dtypes, and
STRUCT-PSPEC / STRUCT-STALE the port's own cohort_pspecs; and
``python -m repro_torch.analysis src/repro_torch`` is clean with an
empty baseline.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import repro_torch as rt
from repro.analysis import REGISTRY as REF_REGISTRY
from repro.analysis import foldin as ref_foldin
from repro.analysis import prng as ref_prng
from repro_torch.analysis import NOISE_SALT, REGISTRY
from repro_torch.analysis import foldin, prng, salts, structure
from repro_torch.analysis.base import (Violation, apply_baseline,
                                       iter_py_files, load_baseline,
                                       module_name)
from repro_torch.analysis.runner import main, run_analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _rules(violations):
    return [v.rule for v in violations]


def _src(code: str) -> str:
    return textwrap.dedent(code)


# --- salt registry -----------------------------------------------------------

def test_registry_values_unique_and_clean():
    values = [s.value for s in REGISTRY.values()]
    assert len(values) == len(set(values))
    assert salts.check_registry() == []
    assert REGISTRY["SPEED_SALT"].value == 0x5BEED
    assert NOISE_SALT == 0x5EED


def test_registry_equals_the_reference():
    """Same names, values and chains; the sites name the port's
    modules in place of the reference's."""
    assert salts.salt_names() == sorted(REF_REGISTRY)
    for name, ref in REF_REGISTRY.items():
        s = REGISTRY[name]
        assert (s.name, s.value, s.chain) == (ref.name, ref.value,
                                              ref.chain)
        assert s.sites == tuple("repro_torch." + m[len("repro."):]
                                for m in ref.sites)
        assert getattr(salts, name) == ref.value


def test_noise_salt_has_both_engine_sites():
    """One DP chain, two roots BY DESIGN (parity needs identical noise)."""
    s = REGISTRY["NOISE_SALT"]
    assert set(s.sites) == {"repro_torch.cohort.engine",
                            "repro_torch.cohort.device"}


def test_registry_collision_fires(monkeypatch):
    clone = dict(REGISTRY)
    clone["EVIL_SALT"] = salts.Salt("EVIL_SALT", NOISE_SALT,
                                    "collides with the DP chain", ("x",))
    monkeypatch.setattr(salts, "REGISTRY", clone)
    found = salts.check_registry()
    assert _rules(found) == ["PRNG-COLLISION"]
    assert "EVIL_SALT" in found[0].message
    assert "NOISE_SALT" in found[0].message


def test_declare_rejects_duplicate_name(monkeypatch):
    monkeypatch.setattr(salts, "REGISTRY", dict(REGISTRY))
    with pytest.raises(ValueError):
        salts._declare("NOISE_SALT", 0x1, chain="dup", sites=("x",))


# --- the reference's lint snippets, respelled for the port -------------------
# name -> (lint, (ref path, ref source), (port path, port source), rules,
#          substrings of the first message)

_CASES = {
    # the ad-hoc 0x5BEED before the registry existed
    "prng_raw_literal": ("prng", ("fake/availability.py", """
        import numpy as np
        def draw(seed):
            return np.random.default_rng(seed ^ 0x5BEED)
    """), ("fake/availability.py", """
        import numpy as np
        def draw(seed):
            return np.random.default_rng(seed ^ 0x5BEED)
    """), ["PRNG-UNDECLARED"], ["0x5beed"]),
    "prng_locally_assigned_salt": ("prng", ("fake/mod.py", """
        import jax
        MY_SALT = 0x1234
        def key(seed):
            return jax.random.PRNGKey(seed ^ MY_SALT)
    """), ("fake/mod.py", """
        from repro_torch import prng
        MY_SALT = 0x1234
        def key(seed):
            return prng.PRNGKey(seed ^ MY_SALT)
    """), ["PRNG-LOCAL"], []),
    "prng_unknown_salt_name": ("prng", ("fake/mod.py", """
        from jax.random import PRNGKey
        def key(seed):
            return PRNGKey(seed ^ MYSTERY_SALT)
    """), ("fake/mod.py", """
        from repro_torch.prng import PRNGKey
        def key(seed):
            return PRNGKey(seed ^ MYSTERY_SALT)
    """), ["PRNG-UNKNOWN"], []),
    "prng_wrong_import_origin": ("prng", ("fake/mod.py", """
        import jax
        from repro.scenarios.registry import LAT_SALT
        def key(seed):
            return jax.random.PRNGKey(seed ^ LAT_SALT)
    """), ("fake/mod.py", """
        from repro_torch import prng
        from repro_torch.scenarios.registry import LAT_SALT
        def key(seed):
            return prng.PRNGKey(seed ^ LAT_SALT)
    """), ["PRNG-LOCAL"], ["repro_torch.scenarios.registry"]),
    # NOISE_SALT keyed outside its two engine modules: one salt, two
    # meanings
    "prng_undeclared_site": ("prng", ("src/repro/scenarios/rogue.py", """
        import jax
        from repro.analysis.salts import NOISE_SALT
        def key(seed):
            return jax.random.PRNGKey(seed ^ NOISE_SALT)
    """), ("src/repro_torch/scenarios/rogue.py", """
        from repro_torch import prng
        from repro_torch.analysis.salts import NOISE_SALT
        def key(seed):
            return prng.PRNGKey(seed ^ NOISE_SALT)
    """), ["PRNG-SITE"], ["repro_torch.scenarios.rogue"]),
    "prng_declared_site": ("prng", ("src/repro/cohort/engine.py", """
        import jax
        from repro.analysis.salts import NOISE_SALT
        def key(seed):
            return jax.random.PRNGKey(seed ^ NOISE_SALT)
    """), ("src/repro_torch/cohort/engine.py", """
        from repro_torch import prng
        from repro_torch.analysis.salts import NOISE_SALT
        def key(seed):
            return prng.PRNGKey(seed ^ NOISE_SALT)
    """), [], []),
    "prng_registry_module_attribute": (
        "prng", ("src/repro/scenarios/availability.py", """
        import numpy as np
        from repro.analysis import salts
        def draw(seed):
            return np.random.default_rng(seed ^ salts.SPEED_SALT)
    """), ("src/repro_torch/scenarios/availability.py", """
        import numpy as np
        from repro_torch.analysis import salts
        def draw(seed):
            return np.random.default_rng(seed ^ salts.SPEED_SALT)
    """), [], []),
    # RenewalChurn's real pattern: the XOR nested in mix arithmetic
    "prng_xor_inside_larger_expression": ("prng", ("fake/mod.py", """
        import numpy as np
        def draw(seed, c):
            return np.random.default_rng(
                ((seed ^ 0xBAD) * 1_000_003 + c) & 0xFFFFFFFF)
    """), ("fake/mod.py", """
        import numpy as np
        def draw(seed, c):
            return np.random.default_rng(
                ((seed ^ 0xBAD) * 1_000_003 + c) & 0xFFFFFFFF)
    """), ["PRNG-UNDECLARED"], []),
    "prng_unsalted_roots": ("prng", ("fake/mod.py", """
        import jax
        import numpy as np
        def keys(seed, step):
            a = jax.random.PRNGKey(seed)
            b = np.random.default_rng(seed * 65_537 + step)
            return a, b
    """), ("fake/mod.py", """
        import numpy as np
        from repro_torch import prng
        def keys(seed, step):
            a = prng.PRNGKey(seed)
            b = np.random.default_rng(seed * 65_537 + step)
            return a, b
    """), [], []),
    "foldin_duplicate_constant": ("foldin", ("fake/mod.py", """
        import jax
        def keys(seed):
            base = jax.random.PRNGKey(seed ^ LAT_SALT)
            upd = jax.random.fold_in(base, 0)
            bc = jax.random.fold_in(base, 0)
            return upd, bc
    """), ("fake/mod.py", """
        from repro_torch import prng
        def keys(seed):
            base = prng.PRNGKey(seed ^ LAT_SALT)
            upd = prng.fold_in(base, 0)
            bc = prng.fold_in(base, 0)
            return upd, bc
    """), ["PRNG-FOLDIN-DUP"], ["LAT_SALT"]),
    "foldin_const_variable_mix": ("foldin", ("fake/mod.py", """
        import jax
        def keys(seed, t):
            base = jax.random.PRNGKey(seed ^ LAT_SALT)
            upd = jax.random.fold_in(base, 0)
            return jax.random.fold_in(base, t)
    """), ("fake/mod.py", """
        from repro_torch import prng
        def keys(seed, t):
            base = prng.PRNGKey(seed ^ LAT_SALT)
            upd = prng.fold_in(base, 0)
            return prng.fold_in(base, t)
    """), ["PRNG-FOLDIN-MIXED"], []),
    # two runtime domains folded at one chain position can collide
    # (tick == client aliases the noise streams)
    "foldin_conflicting_variable_addresses": ("foldin", ("fake/mod.py", """
        import jax
        def keys(seed, tick, client):
            base = jax.random.PRNGKey(seed ^ NOISE_SALT)
            k1 = jax.random.fold_in(base, tick)
            k2 = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
                base, client)
            return k1, k2
    """), ("fake/mod.py", """
        from repro_torch import prng
        def keys(seed, tick, client):
            base = prng.PRNGKey(seed ^ NOISE_SALT)
            k1 = prng.fold_in(base, tick)
            k2 = prng.fold_in(base[None, :], client)
            return k1, k2
    """), ["PRNG-FOLDIN-VAR"], ["tick", "client"]),
    # distinct constant branches, then IDENTICAL variable folds repeated
    # across parity twins
    "foldin_parity_twins_and_const_branches": ("foldin", ("fake/mod.py", """
        import jax
        def keys(seed, k, cidx):
            base = jax.random.PRNGKey(seed ^ LAT_SALT)
            upd = jax.random.fold_in(base, 0)
            bc = jax.random.fold_in(base, 1)
            bk_eager = jax.random.fold_in(bc, k)
            bk_jit = jax.random.fold_in(bc, k)
            return jax.vmap(jax.random.fold_in,
                            in_axes=(None, 0))(upd, cidx)
    """), ("fake/mod.py", """
        from repro_torch import prng
        def keys(seed, k, cidx):
            base = prng.PRNGKey(seed ^ LAT_SALT)
            upd = prng.fold_in(base, 0)
            bc = prng.fold_in(base, 1)
            bk_host = prng.fold_in(bc, k)
            bk_dev = prng.fold_in(bc, k).to("cpu")
            return prng.fold_in(upd[None, :], cidx)
    """), [], []),
    # the same salt may root differently-addressed chains in different
    # top-level units
    "foldin_chains_scoped_per_toplevel_unit": ("foldin", ("fake/mod.py", """
        import jax
        def markov(seed, t):
            base = jax.random.PRNGKey(seed ^ AVAIL_SALT)
            return jax.random.fold_in(base, t // 8)
        def renewal(seed, e):
            base = jax.random.PRNGKey(seed ^ AVAIL_SALT)
            return jax.random.fold_in(base, e)
    """), ("fake/mod.py", """
        from repro_torch import prng
        def markov(seed, t):
            base = prng.PRNGKey(seed ^ AVAIL_SALT)
            return prng.fold_in(base, t // 8)
        def renewal(seed, e):
            base = prng.PRNGKey(seed ^ AVAIL_SALT)
            return prng.fold_in(base, e)
    """), [], []),
    "foldin_unsalted_roots": ("foldin", ("fake/mod.py", """
        import jax
        def keys(seed, tick, client):
            base = jax.random.PRNGKey(seed)
            return (jax.random.fold_in(base, tick),
                    jax.random.fold_in(base, client))
    """), ("fake/mod.py", """
        from repro_torch import prng
        def keys(seed, tick, client):
            base = prng.PRNGKey(seed)
            return (prng.fold_in(base, tick),
                    prng.fold_in(base, client))
    """), [], []),
}

_LINTS = {"prng": (prng, ref_prng), "foldin": (foldin, ref_foldin)}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_snippet_fires_the_reference_rule(name):
    lint, (rpath, rsrc), (path, src), rules, words = _CASES[name]
    ours, ref = _LINTS[lint]
    want = ref.check_file(rpath, _src(rsrc))
    assert _rules(want) == rules          # the reference's own verdict
    found = ours.check_file(path, _src(src))
    assert _rules(found) == rules
    for w in words:
        assert w in found[0].message


def test_foldin_key_views_carry_the_chain():
    """A moved or indexed key (``.to(dev)``, ``[None, :]``) is the same
    chain: the same constant folded through a view aliases it."""
    found = foldin.check_file("fake/mod.py", _src("""
        from repro_torch import prng
        def keys(seed, dev):
            base = prng.PRNGKey(seed ^ LAT_SALT)
            a = prng.fold_in(base.to(dev)[None, :], 0)
            b = prng.fold_in(base, 0)
            return a, b
    """))
    assert _rules(found) == ["PRNG-FOLDIN-DUP"]


def test_foldin_twins_must_spell_the_address_identically():
    """The port's parity twins must spell the address identically
    (``k`` and ``int(k)`` are two expressions to the lint)."""
    found = foldin.check_file("fake/mod.py", _src("""
        from repro_torch import prng
        class Plan:
            def __init__(self, seed):
                self._bc_base = prng.fold_in(prng.PRNGKey(seed ^ LAT_SALT), 1)
            def ticks(self, k):
                return prng.fold_in(self._bc_base, k)
            def seconds(self, k):
                return prng.fold_in(self._bc_base, int(k))
    """))
    assert _rules(found) == ["PRNG-FOLDIN-VAR"]


def test_lints_audit_the_port_and_find_it_clean():
    files = iter_py_files([PORT])
    assert files, "expected the port's sources"
    assert prng.check_files(files) == []
    assert foldin.check_files(files) == []
    # the audit is live: the engines' salted roots are seen
    dev = os.path.join(PORT, "cohort", "device.py")
    src = open(dev).read().replace("NOISE_SALT)", "0x5EED)", 1)
    assert _rules(prng.check_file(dev, src)) == ["PRNG-UNDECLARED"]


# --- structure ---------------------------------------------------------------

def test_struct_dtype_discipline_fires():
    fields = {
        "w": torch.zeros(3, dtype=torch.float64),   # must be f32
        "k": torch.zeros(3, dtype=torch.int64),     # must be i32
        "flag": torch.zeros(3, dtype=torch.bool),   # non-numeric class
        "ok_f": torch.zeros(3, dtype=torch.float32),
        "ok_i": torch.zeros(3, dtype=torch.int32),
    }
    found = structure.check_state_dtypes(fields)
    assert sorted(_rules(found)) == ["STRUCT-DTYPE"] * 3
    assert {v.message.split("'")[1] for v in found} == {"w", "k", "flag"}
    # the reference's rule on the same dtypes as numpy
    from repro.analysis import structure as ref_structure
    ref = ref_structure.check_state_dtypes(
        {k: v.numpy() for k, v in fields.items()})
    assert sorted((v.rule, v.message.split("'")[1]) for v in ref) == \
        sorted((v.rule, v.message.split("'")[1]) for v in found)


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64,
                                   torch.int16, torch.bfloat16])
def test_struct_dtype_fires_on_a_planted_state_field(dtype):
    st = structure._tiny_device_state("cpu")
    assert structure.check_state_dtypes(st) == []
    st["messages"] = st["messages"].to(dtype)
    found = structure.check_state_dtypes(st)
    assert _rules(found) == ["STRUCT-DTYPE"]
    assert "'messages'" in found[0].message


def test_struct_live_port_state_is_clean():
    assert structure.check_cohort_structure("cpu") == []


def test_struct_missing_pspec_fires():
    found = structure.check_state_coverage(["w", "new_field"], {"w": None})
    assert _rules(found) == ["STRUCT-PSPEC"]
    assert "new_field" in found[0].message


def test_struct_stale_spec_fires():
    found = structure.check_state_coverage(
        ["w"], {"w": None, "renamed_away": None})
    assert _rules(found) == ["STRUCT-STALE"]
    assert "renamed_away" in found[0].message


@pytest.mark.parametrize("plant", ["dropped", "dead", "both"])
def test_struct_coverage_on_the_live_specs_matches_the_reference(plant):
    """The port's cohort_pspecs cover DeviceCohortState exactly; a spec
    table with a field dropped, a dead field added, or both, gives the
    reference's rules on the same names."""
    from repro.analysis import structure as ref_structure
    from repro_torch.cohort.state import DeviceCohortState
    from repro_torch.sharding import MeshShape, cohort_pspecs
    fields = DeviceCohortState._fields
    specs = cohort_pspecs(MeshShape(("clients",), (4,)), 16)
    assert structure.check_state_coverage(fields, specs) == []
    if plant in ("dropped", "both"):
        specs = {f: s for f, s in specs.items() if f != "bc_at"}
    if plant in ("dead", "both"):
        specs = dict(specs, w_old=specs["w"])
    found = structure.check_state_coverage(fields, specs)
    ref = ref_structure.check_state_coverage(fields, specs)
    want = {"dropped": ["STRUCT-PSPEC"], "dead": ["STRUCT-STALE"],
            "both": ["STRUCT-PSPEC", "STRUCT-STALE"]}[plant]
    assert _rules(found) == _rules(ref) == want
    assert [v.message.split("'")[1] for v in found] == \
        [v.message.split("'")[1] for v in ref]


def test_struct_check_reads_the_port_specs(monkeypatch):
    """check_cohort_structure reports a field the live specs lack."""
    from repro_torch.sharding import specs as tspecs
    real = tspecs.cohort_pspecs
    monkeypatch.setattr(tspecs, "cohort_pspecs", lambda m, n: {
        f: s for f, s in real(m, n).items() if f != "iters"})
    import repro_torch.sharding as sh
    monkeypatch.setattr(sh, "cohort_pspecs", tspecs.cohort_pspecs)
    found = structure.check_cohort_structure("cpu")
    assert _rules(found) == ["STRUCT-PSPEC"] and "'iters'" in \
        found[0].message


# --- baseline / plumbing -----------------------------------------------------

def test_violation_key_survives_line_drift(tmp_path):
    a = Violation("R", "pkg/f.py", 10, "msg")
    b = Violation("R", "other/f.py", 99, "msg")
    assert a.key() == b.key()
    base = tmp_path / "baseline.txt"
    base.write_text(f"# comment\n{a.key()}\n")
    assert apply_baseline([a, b], load_baseline(str(base))) == []


def test_module_name_derivation():
    assert module_name("src/repro_torch/cohort/engine.py") == \
        "repro_torch.cohort.engine"
    assert module_name("src/repro_torch/analysis/__init__.py") == \
        "repro_torch.analysis"
    assert module_name("scratch.py") == "scratch"


# --- CLI ---------------------------------------------------------------------

def test_cli_clean_file_exits_zero(tmp_path, capsys):
    f = tmp_path / "clean.py"
    f.write_text("x = 1\n")
    assert main(["--no-structure", str(f)]) == 0
    assert "OK" in capsys.readouterr().out


def test_cli_finding_exits_one_and_baseline_suppresses(tmp_path, capsys):
    f = tmp_path / "bad.py"
    f.write_text("from repro_torch import prng\n"
                 "def key(seed):\n"
                 "    return prng.PRNGKey(seed ^ 0xBAD)\n")
    assert main(["--no-structure", str(f)]) == 1
    out = capsys.readouterr().out
    assert "PRNG-UNDECLARED" in out and "FAILED" in out
    # baseline: a local triage channel (the pass ships an empty one)
    all_v, _ = run_analysis([str(f)], structure=False)
    base = tmp_path / "baseline.txt"
    base.write_text("\n".join(v.key() for v in all_v) + "\n")
    assert main(["--no-structure", "--baseline", str(base), str(f)]) == 0
    assert "suppressed" in capsys.readouterr().out


def test_cli_list_salts(capsys):
    assert main(["--list-salts"]) == 0
    out = capsys.readouterr().out
    assert "NOISE_SALT" in out and "repro_torch.cohort.device" in out


def test_cli_trace_checks_a_port_trace(tmp_path, capsys):
    X, y = rt.make_binary_dataset(120, 6, seed=3, noise=0.3)
    path = tmp_path / "run.jsonl"
    rt.DeviceCohortSimulator(
        rt.LogRegTask(X, y, l2=0.01, sample_seed=7), n_clients=4,
        sizes_per_client=[3, 4], round_stepsizes=[0.1, 0.08], d=2, seed=4,
        block=4, scenario="mobile_diurnal", trace=str(path),
        device="cpu").run(max_rounds=3, eval_every=1)
    assert main(["--no-structure", "--trace", str(path), "--d", "2"]) == 0
    # a regressed segment counter: the last segment's round set below
    # every earlier one
    records = [json.loads(ln) for ln in path.read_text().splitlines()]
    segs = [r for r in records if r["kind"] == "segment"]
    assert len(segs) >= 2
    segs[-1]["round"] = -1
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    capsys.readouterr()
    assert main(["--no-structure", "--trace", str(path), "--d", "2"]) == 1
    assert "INV-MONO" in capsys.readouterr().out


def test_cli_structure_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_analysis([], structure=True)


def test_cli_repo_pass_is_blocking_contract():
    """The exact invocation users run, as a process: structure included,
    no baseline, clean."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", PORT, "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("OK: ")
    all_v, new_v = run_analysis([PORT], device="cpu")
    assert new_v == [] and all_v == []
