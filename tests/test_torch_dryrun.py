"""The port's dry run (repro_torch.launch.dryrun) on fake process groups
on the CPU, at ``reduced()`` widths and cut shapes: the reference's
depth extrapolation equals the full-depth count; a fake one-rank dry run
equals the same step run for real on a one-rank gloo mesh in flops,
bytes, peak and argument bytes, with no collective; the client axis
counts each pod's update once; the counter's byte rules; and the CLI.
``test_torch_dryrun_meshes.py`` runs ``dryrun_one`` on 2x2 and 2x2x2."""
import json

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as T
from repro_torch.launch import dryrun, inputs, roofline
from repro_torch.launch.mesh import make_fake_mesh, make_host_mesh

SHAPES = {"train": T.ShapeConfig("train_cut", 64, 8, "train"),
          "prefill": T.ShapeConfig("prefill_cut", 128, 4, "prefill"),
          "decode": T.ShapeConfig("decode_cut", 128, 4, "decode")}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on a few
    cores, and these tests' small CPU ops only lose to thread hand-offs
    there."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(key):
    shape, names = MESHES[key]
    return make_fake_mesh(shape, names, device="cpu")


@pytest.mark.parametrize("arch,L", [("gemma2-2b", 6), ("mamba2-780m", 3)])
def test_corrected_costs_equal_the_full_depth_count(arch, L):
    """The reference's extrapolation from depths P and 2P (P the
    local/global period) equals the L-layer count — three periods, so
    not by construction — because every period costs the same: the
    layers are unbound once (``transformer.layers``), so the stacked
    gradients' bytes grow linearly with depth."""
    cfg = T.reduced(T.get_config(arch), n_layers=L)
    assert cfg.n_layers == L
    assert L // (cfg.local_global_period or 1) == 3
    mesh = _mesh("2x2")
    shape = SHAPES["train"]
    rc = T.RunConfig(model=cfg)
    full = dryrun.count_step(cfg, rc, shape, mesh)
    flops, byts, coll = dryrun.corrected_costs(cfg, rc, shape, mesh)
    assert flops == full.flops * 4
    assert byts == full.bytes * 4
    assert sum(coll.values()) == sum(full.coll.values()) * 4


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-780m",
                                  "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_fake_one_rank_dry_run_equals_a_real_cpu_run(arch, kind):
    cfg = T.reduced(T.get_config(arch))
    shape, rc = SHAPES[kind], T.RunConfig(model=cfg)
    dry = dryrun.count_step(cfg, rc, shape,
                            make_fake_mesh((1, 1), ("data", "model"),
                                           device="cpu"))
    assert sum(dry.coll.values()) == 0
    dist.destroy_process_group()
    mesh = make_host_mesh(device="cpu")
    assert dist.get_backend() == "gloo"
    step, args = dryrun.build_step(cfg, rc, shape, mesh)
    dryrun.fill_inputs(args, cfg.vocab_size, seed=0)
    with implicit_replication(), FlopCounterMode(display=False) as fc:
        out = step(*args)
    assert fc.get_total_flops() == dry.flops > 0
    assert inputs.local_bytes(list(args)) == dry.argument_bytes
    real = dryrun.trace(step, args)
    assert (real.flops, real.bytes, real.temp_bytes) == \
        (dry.flops, dry.bytes, dry.temp_bytes)
    assert sum(real.coll.values()) == 0
    del out


def test_client_axis_counts_each_pod_once():
    """C = 2 clients on 2x2x2 (each pod its client's update on its 2x2
    sub-mesh) against C = 1 on 2x2 at the same per-client batch: twice
    the flops over all chips, plus the cross-pod all-reduce of U."""
    cfg = T.reduced(T.get_config("gemma2-2b"))
    rc = T.RunConfig(model=cfg)
    one = dryrun.count_step(cfg, rc, T.ShapeConfig("t", 64, 4, "train"),
                            _mesh("2x2"))
    two = dryrun.count_step(cfg, rc, T.ShapeConfig("t", 64, 8, "train"),
                            _mesh("2x2x2"))
    assert two.flops * 8 == 2 * (one.flops * 4)
    grad_bytes = inputs.local_bytes([
        v for k, v in _params_local(cfg, "2x2").items()])
    assert two.coll["all_reduce"] - one.coll["all_reduce"] >= grad_bytes


def _params_local(cfg, key):
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = _mesh(key)
    with FakeTensorMode():
        params, _ = inputs.params_spec(cfg, mesh)
    from repro_torch import tree
    return dict(enumerate(tree.leaves(params)))


def test_counter_counts_addressed_bytes_and_skips_views():
    x = torch.zeros(4, 8)
    b = torch.zeros(8).expand(4, 8)
    assert roofline.addressed_bytes(b) == 8 * 4
    with roofline.StepCounter(known=[x, b]) as c:
        y = x.view(2, 16)            # a view: no bytes
        z = x + b                    # 128 + 32 in, 128 out
        w = torch.mm(x, x.T)         # 2*4*8*4 flops
    assert c.bytes == 128 + 32 + 128 + (128 + 128 + 64)
    assert c.flops == 2 * 4 * 8 * 4
    assert c.peak == 128 + 64 and c.live == 128 + 64
    del z, w, y
    assert c.live == 0


def test_main_raises_without_cuda_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "gemma2-2b", "--shape", "decode_32k"])
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: T.reduced(T.get_config(a)))
    monkeypatch.setattr(dryrun, "INPUT_SHAPES",
                        {"decode_32k": SHAPES["decode"]})
    out = tmp_path / "dryrun_torch.json"
    assert dryrun.main(["--arch", "gemma2-2b", "--shape", "decode_32k",
                        "--both-meshes", "--device", "cpu", "--out",
                        str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [(r["mesh"], r["status"]) for r in rows] == \
        [("16x16", "OK"), ("2x16x16", "OK")]
    keys = set(roofline.RooflineReport(
        "a", "s", "m", 1, 1.0, 1.0, 0.0, {}, 1.0).to_dict())
    for r in rows:
        assert set(r["roofline"]) == keys
        assert set(r["memory_analysis"]) == {
            "temp_size_in_bytes", "argument_size_in_bytes",
            "output_size_in_bytes", "generated_code_size_in_bytes"}
