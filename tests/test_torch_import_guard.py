"""The port stands alone: no jax, no reference package, no CPU fallback.

``repro_torch``, ``chip_smoke.py``, ``chip_walls.py`` and
``chip_passes.py`` import torch, numpy and the standard library only; a
fresh interpreter that imports the port and runs a small CPU simulation
loads neither ``jax`` nor any ``repro`` module; and the entry point
refuses to run without CUDA unless the caller asks for the CPU.
"""
import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py",
                                           "chip_walls.py",
                                           "chip_passes.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert bad == [], f"{path} imports {bad}"


def test_port_runs_without_loading_jax_or_the_reference():
    code = textwrap.dedent("""
        import sys
        import repro_torch as rt
        X, y = rt.make_binary_dataset(200, 8, seed=0)
        task = rt.LogRegTask(X, y, l2=0.005, dp_clip=0.1, dp_sigma=2.0,
                             sample_seed=1)
        sim = rt.DeviceCohortSimulator(
            task, n_clients=5, sizes_per_client=[3, 4], d=2,
            round_stepsizes=[0.1, 0.1], block=4, dp_round_clip=1.0,
            device="cpu")
        res = sim.run(max_rounds=2)
        assert res["final"]["round"] == 2
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_point_raises_without_cuda(monkeypatch):
    import repro_torch as rt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = rt.make_binary_dataset(50, 4, seed=0)
    task = rt.LogRegTask(X, y, sample_seed=0)
    kw = dict(n_clients=3, sizes_per_client=[2], round_stepsizes=[0.1])
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.DeviceCohortSimulator(task, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.DeviceCohortSimulator(task, **kw, device="cuda")
    assert rt.DeviceCohortSimulator(task, **kw, device="cpu").device.type \
        == "cpu"


def test_model_paths_run_without_loading_jax_or_the_reference():
    """The DP round, the attention layer and the SSD mixer, each on its
    plain CPU route, load neither jax nor the reference package."""
    code = textwrap.dedent("""
        import sys
        import torch
        from repro_torch import prng
        from repro_torch.configs import gemma2_2b, mamba2_780m, reduced
        from repro_torch.convert import layer
        from repro_torch.dp import dp_sgd_round
        from repro_torch.models import attention, logreg, ssm
        X = torch.randn(12, 5)
        y = (torch.rand(12) < 0.5).float()
        U, loss = dp_sgd_round(
            lambda p, ex: logreg.per_example_loss(p, ex[0], ex[1]),
            logreg.init_params(5, device="cpu"), (X, y), clip_norm=0.1,
            sigma=1.0, rng=prng.PRNGKey(0), microbatch=4)
        assert U["w"].shape == (5,) and torch.isfinite(loss)
        cfg = reduced(gemma2_2b.config())
        lp = layer(attention.init_attention(cfg, prng.PRNGKey(1),
                                            torch.float32, device="cpu"), 0)
        x = torch.randn(1, 9, cfg.d_model)
        out = attention.attend_full(cfg, lp, x, torch.arange(9)[None], 4)
        assert out.shape == x.shape
        cfg = reduced(mamba2_780m.config())
        lp = layer(ssm.init_ssm(cfg, prng.PRNGKey(2), torch.float32,
                                device="cpu"), 0)
        x = torch.randn(1, 9, cfg.d_model)
        assert ssm.apply_ssm(cfg, lp, x).shape == x.shape
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_model_initializers_default_to_the_card(monkeypatch):
    from repro_torch import prng
    from repro_torch.configs import gemma2_2b, mamba2_780m, reduced
    from repro_torch.models import attention, ssm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        attention.init_attention(reduced(gemma2_2b.config()),
                                 prng.PRNGKey(0), torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ssm.init_ssm(reduced(mamba2_780m.config()), prng.PRNGKey(0),
                     torch.float32)
