"""The port's sharding rules (repro_torch.sharding), input shapes,
applicability, decode cache lengths, MODEL_FLOPS and report against the
live reference (repro.sharding, repro.configs, repro.launch), ``==``
throughout; and the port's own pieces: spec -> DTensor placements, the
meshes over the fake process group, and the sharding hooks, which are
the identity (bit for bit, output and gradient) with no spec installed.

The reference's rules read a mesh's ``axis_names`` and ``devices``
array only (``repro/sharding/specs.py:33-34``), so they take a stand-in
of each production mesh's shape; the port's take a ``MeshShape`` (and a
real ``DeviceMesh`` over the fake group, in one case)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as J
import repro.launch.inputs as jinputs
import repro.launch.report as jreport
import repro.launch.roofline as jroof
import repro.models as jmodels
import repro.sharding.specs as jspecs
import repro_torch.configs as T
import repro_torch.launch.inputs as tinputs
import repro_torch.launch.report as treport
import repro_torch.launch.roofline as troof
import repro_torch.models as tmodels
import repro_torch.sharding.specs as tspecs
from repro_torch import prng
from repro_torch.sharding import context

MESHES = {"1x1": (("data", "model"), (1, 1)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on a few
    cores, and these tests' small CPU ops only lose to thread hand-offs
    there."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class _RefMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, names, shape):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def _meshes(key):
    names, shape = MESHES[key]
    return _RefMesh(names, shape), tspecs.MeshShape(names, shape)


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jspecs._path_str(p): v for p, v in flat}


def _port_paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_paths(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def _entries(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in tuple(spec))


@pytest.fixture
def no_fsdp(request, monkeypatch):
    monkeypatch.setattr(jspecs, "NO_FSDP", request.param)
    monkeypatch.setattr(tspecs, "NO_FSDP", request.param)
    return request.param


_REF_SHAPES = {}


def _ref_param_shapes(arch):
    if arch not in _REF_SHAPES:
        cfg = J.get_config(arch)
        _REF_SHAPES[arch] = jax.eval_shape(
            lambda k: jmodels.init_params(cfg, k, jnp.bfloat16),
            jax.random.PRNGKey(0))
    return _REF_SHAPES[arch]


@pytest.mark.parametrize("no_fsdp", [False, True], indirect=True)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", J.ASSIGNED_ARCHS)
def test_param_pspecs_equal_reference(arch, mesh, no_fsdp):
    jm, tm = _meshes(mesh)
    ref = _ref_paths(jspecs.param_pspecs(jm, _ref_param_shapes(arch)))
    shapes = tinputs.params_shapes(T.get_config(arch))
    ours = _port_paths(tspecs.param_pspecs(tm, shapes))
    assert sorted(ours) == sorted(ref)
    for path in ref:
        assert _entries(ours[path]) == _entries(ref[path]), path
    # the meta tree is the reference's eval_shape, leaf by leaf
    ref_shapes = _ref_paths(_ref_param_shapes(arch))
    port_shapes = _port_paths(shapes)
    assert {p: tuple(s.shape) for p, s in ref_shapes.items()} == \
        {p: tuple(s.shape) for p, s in port_shapes.items()}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", J.ASSIGNED_ARCHS)
def test_cache_pspecs_equal_reference(arch, shape, kv):
    jcfg, tcfg = J.get_config(arch), T.get_config(arch)
    jshape, tshape = J.INPUT_SHAPES[shape], T.INPUT_SHAPES[shape]
    L = jinputs.decode_cache_len(jcfg, jshape)
    assert tinputs.decode_cache_len(tcfg, tshape) == L
    B = jshape.global_batch
    jdt = jnp.int8 if kv == "int8" else jnp.bfloat16
    tdt = torch.int8 if kv == "int8" else torch.bfloat16
    jcache = jax.eval_shape(lambda: jmodels.init_cache(jcfg, B, L, jdt))
    tcache = tmodels.init_cache(tcfg, B, L, tdt, device="meta")
    for key in ("16x16", "2x16x16", "1x1"):
        jm, tm = _meshes(key)
        ref = _ref_paths(jspecs.cache_pspecs(jm, jcache))
        ours = _port_paths(tspecs.cache_pspecs(tm, tcache))
        assert {p: _entries(s) for p, s in ours.items()} == \
            {p: _entries(s) for p, s in ref.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_equal_reference(mesh):
    jm, tm = _meshes(mesh)
    for n in (1, 2, 3, 4, 8, 16, 24, 32, 48, 64, 100, 128, 256, 512, 1024):
        for extra in (1, 2):
            assert _entries(tspecs.batch_spec(tm, n, extra)) == \
                _entries(jspecs.batch_spec(jm, n, extra))
            assert _entries(tspecs.client_batch_spec(tm, n, extra)) == \
                _entries(jspecs.client_batch_spec(jm, n, extra))
        assert tspecs._fit_combined(tm, n) == jspecs._fit_combined(jm, n)
        assert tspecs.batch_axes(tm) == jspecs.batch_axes(jm)


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_cohort_pspecs_equal_reference(ranks):
    jm = _RefMesh(("clients",), (ranks,))
    tm = tspecs.MeshShape(("clients",), (ranks,))
    for C in (6, 8, 16384):
        ref = jspecs.cohort_pspecs(jm, C)
        ours = tspecs.cohort_pspecs(tm, C)
        assert list(ours) == list(ref)
        assert {f: _entries(s) for f, s in ours.items()} == \
            {f: _entries(s) for f, s in ref.items()}


def test_input_shapes_equal_reference():
    assert list(T.INPUT_SHAPES) == list(J.INPUT_SHAPES)
    for name, s in J.INPUT_SHAPES.items():
        t = T.INPUT_SHAPES[name]
        assert (t.name, t.seq_len, t.global_batch, t.kind) == \
            (s.name, s.seq_len, s.global_batch, s.kind)


@pytest.mark.parametrize("arch", J.ASSIGNED_ARCHS)
def test_applicability_cache_len_and_model_flops_equal_reference(arch):
    jcfg, tcfg = J.get_config(arch), T.get_config(arch)
    for name in J.INPUT_SHAPES:
        js, ts = J.INPUT_SHAPES[name], T.INPUT_SHAPES[name]
        assert tinputs.shape_is_applicable(tcfg, name) == \
            jinputs.shape_is_applicable(jcfg, name)
        assert tinputs.decode_cache_len(tcfg, ts) == \
            jinputs.decode_cache_len(jcfg, js)
        for bw in (False, True):
            assert troof.model_flops(tcfg, ts, backward=bw) == \
                jroof.model_flops(jcfg, js, backward=bw)


def _results():
    rf = troof.RooflineReport(
        arch="gemma2-2b", shape="train_4k", mesh="16x16", chips=256,
        hlo_flops=3.5e17, hlo_bytes=2.25e15, coll_bytes=4.5e13,
        coll_breakdown={"all_gather": 45}, model_flops_total=1.2e17,
        compile_seconds=12.5).to_dict()
    return [
        {"arch": "gemma2-2b", "shape": "train_4k", "mesh": "16x16",
         "status": "OK", "roofline": rf,
         "memory_analysis": {"argument_size_in_bytes": 2.5e9,
                             "temp_size_in_bytes": 7.25e9}},
        {"arch": "gemma2-2b", "shape": "train_4k", "mesh": "2x16x16",
         "status": "OK", "roofline": dict(rf, mesh="2x16x16"),
         "memory_analysis": {"argument_size_in_bytes": 2.5e9,
                             "temp_size_in_bytes": 3.5e9}},
        {"arch": "gemma-2b", "shape": "long_500k", "mesh": "16x16",
         "status": "SKIP", "reason": "pure full-attention arch"},
        {"arch": "grok-1-314b", "shape": "train_4k", "mesh": "16x16",
         "status": "FAIL", "error": "x" * 100},
    ]


def test_report_renders_the_reference_tables(tmp_path):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(_results()))
    ref = jreport.render(str(path)).splitlines()
    ours = treport.render(str(path)).splitlines()
    assert len(ours) == len(ref)
    diff = [(a, b) for a, b in zip(ours, ref) if a != b]
    assert diff == [("### Roofline (16x16, 256 chips, H100 constants)",
                     "### Roofline (16x16, 256 chips, v5e constants)")]


def test_roofline_report_has_reference_fields_and_h100_constants():
    kw = dict(arch="a", shape="s", mesh="16x16", chips=256,
              hlo_flops=1e18, hlo_bytes=1e15, coll_bytes=1e13,
              coll_breakdown={}, model_flops_total=5e17)
    ours, ref = troof.RooflineReport(**kw), jroof.RooflineReport(**kw)
    assert set(ours.to_dict()) == set(ref.to_dict())
    assert ours.useful_ratio == ref.useful_ratio
    assert ours.compute_s == 1e18 / (256 * 989e12)
    assert ours.memory_s == 1e15 / (256 * 3.35e12)
    assert ours.collective_s == 1e13 / (256 * 50e9)
    assert troof.PEAK_FLOPS != jroof.PEAK_FLOPS
    assert troof.HBM_BW != jroof.HBM_BW


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = tspecs.MeshShape(("pod", "data", "model"), (2, 16, 16))
    P = tspecs.P
    assert tspecs.placements(m, P(None, "data", "model")) == \
        [Replicate(), Shard(1), Shard(2)]
    assert tspecs.placements(m, P(("pod", "data"), None)) == \
        [Shard(0), Shard(0), Replicate()]
    assert tspecs.placements(m, P()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="shards two dims"):
        tspecs.placements(m, P("data", "data"))


@pytest.fixture
def fake_group():
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_production_meshes_are_fake_groups_of_256_and_512(fake_group):
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    m = tmesh.make_production_mesh(device="cpu")
    assert (m.mesh_dim_names, tuple(m.shape)) == (("data", "model"),
                                                  (16, 16))
    assert dist.get_backend() == "fake" and dist.get_world_size() == 256
    assert tmesh.n_chips(m) == 256
    shapes = tinputs.params_shapes(T.get_config("gemma2-2b"))
    assert _port_paths(tspecs.param_pspecs(m, shapes)) == \
        _port_paths(tspecs.param_pspecs(tspecs.MeshShape(*MESHES["16x16"]),
                                        shapes))
    m2 = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert tmesh.mesh_axis_sizes(m2) == {"pod": 2, "data": 16, "model": 16}
    assert dist.get_world_size() == 512 and tmesh.n_chips(m2) == 512


def test_production_mesh_on_the_card_needs_cuda(monkeypatch, fake_group):
    from repro_torch.launch import mesh as tmesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_production_mesh()


def _grads(cfg, params, batch):
    flat = [p.detach().requires_grad_(True)
            for p in tmodels_tree_leaves(params)]
    from repro_torch import tree
    loss = tmodels.train_loss(cfg, tree.unflatten(params, flat), batch)
    return loss, torch.autograd.grad(loss, flat)


def tmodels_tree_leaves(t):
    from repro_torch import tree
    return tree.leaves(t)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-moe-a2.7b",
                                  "whisper-large-v3"])
def test_hooks_are_the_identity_without_a_spec(arch, monkeypatch):
    """Output and gradient bit for bit against the model with every hook
    patched out; and a spec installed changes nothing on plain tensors."""
    from repro_torch.models import encdec, moe, transformer
    cfg = T.reduced(T.get_config(arch))
    params = tmodels.init_params(cfg, prng.PRNGKey(0), torch.float32,
                                 device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 17),
                                     generator=g)}
    if cfg.family == "encdec":
        batch["encoder_embeds"] = torch.randn(
            2, cfg.encoder_seq_len, cfg.d_model, generator=g)
    loss, grads = _grads(cfg, params, batch)
    from repro_torch.launch.dryrun import _drop_leading
    cot = _drop_leading(tspecs.param_pspecs(
        tspecs.MeshShape(*MESHES["16x16"]), params)[
            "decoder" if cfg.family == "encdec" else "blocks"])
    with context.use_activation_spec(tspecs.P("data", "model")), \
            context.use_param_cotangent_specs(cot):
        loss_s, grads_s = _grads(cfg, params, batch)
    ident = lambda x, **k: x  # noqa: E731
    for mod, names in ((transformer, ("constrain",
                                      "shard_layer_param_cotangents")),
                       (encdec, ("constrain",)),
                       (moe, ("constrain", "constrain_expert"))):
        for n in names:
            monkeypatch.setattr(mod, n, ident)
    loss_p, grads_p = _grads(cfg, params, batch)
    assert torch.equal(loss, loss_p) and torch.equal(loss_s, loss_p)
    for a, b, c in zip(grads, grads_p, grads_s):
        assert torch.equal(a, b) and torch.equal(c, b)
