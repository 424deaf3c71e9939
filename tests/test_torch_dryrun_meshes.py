"""``dryrun_one`` (repro_torch.launch.dryrun) on fake 2x2 and 2x2x2 CPU
meshes at ``reduced()`` widths and cut shapes: every step is OK, its
argument bytes are the local shards summed by hand from the rules,
sequence parallelism issues collectives, and (train, 2x2) the
reference's depth extrapolation equals the full-depth count."""
import math

import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as T
from repro_torch.launch import dryrun, inputs
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.sharding import specs as tspecs

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


def _local(shape, spec, sizes):
    """Rank 0's shard shape: each dim split over its axes' product,
    ceil-sized (torch.chunk's first chunk)."""
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        k = math.prod(sizes[a] for a in axes)
        out.append(-(-n // k))
    return out


def _hand_argument_bytes(cfg, shape, key):
    """Argument bytes of one rank from the rules, summed by hand."""
    names = MESHES[key][1]
    m = tspecs.MeshShape(names, MESHES[key][0])
    sizes = dict(zip(names, MESHES[key][0]))
    shapes = inputs.params_shapes(cfg)
    specs = tspecs.param_pspecs(m, shapes)

    def walk(t, s):
        if isinstance(t, dict):
            return sum(walk(t[k], s[k]) for k in t)
        return math.prod(_local(t.shape, s, sizes)) * t.element_size()
    n = walk(shapes, specs)
    C = sizes.get("pod", 1)
    if shape.kind == "train":
        B = shape.global_batch // C
        spec = tspecs.client_batch_spec(m, B, extra_dims=1)
        n += math.prod(_local((C, B, shape.seq_len), spec, sizes)) * 4
        n += 4 + 16                       # the step size and the key
    elif shape.kind == "prefill":
        spec = tspecs.batch_spec(m, shape.global_batch, extra_dims=1)
        n += math.prod(_local((shape.global_batch, shape.seq_len), spec,
                              sizes)) * 4
    else:
        B = shape.global_batch
        L = inputs.decode_cache_len(cfg, shape)
        from repro_torch.models import init_cache
        cache = init_cache(cfg, B, L, torch.bfloat16, device="meta")
        n += walk(cache, tspecs.cache_pspecs(m, cache))
        n += math.prod(_local((B, 1), tspecs.batch_spec(m, B), sizes)) * 4
    return n


CASES = [(a, m) for a in ("gemma2-2b", "mamba2-780m", "qwen2-moe-a2.7b")
         for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_dryrun_one_is_ok_on_fake_meshes(arch, mesh):
    cfg = T.reduced(T.get_config(arch))
    for kind, shape in SHAPES.items():
        roof = mesh == "2x2" and kind == "train"
        r = dryrun.dryrun_one(arch, None, multi_pod=mesh == "2x2x2",
                              verbose=False, cfg=cfg, mesh=_mesh(mesh),
                              shape=shape, with_roofline=roof)
        assert r["status"] == "OK", r.get("error")
        assert r["mesh"] == mesh
        ma, rf = r["memory_analysis"], r["roofline"]
        assert ma["argument_size_in_bytes"] == \
            _hand_argument_bytes(cfg, shape, mesh)
        assert ma["generated_code_size_in_bytes"] == 0.0
        assert ma["temp_size_in_bytes"] > 0 and rf["hlo_flops"] > 0
        assert rf["chips"] == math.prod(MESHES[mesh][0])
        if kind != "decode":        # seqpar: the sequence's gathers
            assert rf["coll_bytes"] > 0
        if roof:                    # the depth check, once a case
            assert r["corrected_costs"]["equal"], r["corrected_costs"]
        else:
            assert "corrected_costs" not in r


