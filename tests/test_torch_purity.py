"""The port's traced-code purity lint (``repro_torch.analysis.purity``).

Twins of ``tests/test_analysis.py``'s ``test_purity_*`` cases: each
snippet respelled for torch's consumers (``torch.compile``,
``torch.func.vmap`` / ``grad``, ``torch.utils.checkpoint``, the dry
run's ``make_*_step`` closures in place of ``jax.jit``, ``lax.scan`` and
``tick_plan``) fires the same rules, or stays silent, under the port's
lint as the original under the reference's.  Then the torch spellings:
checkpointed bodies, ``register_fake``, CUDA-graph capture, the closure
stopping at a custom op's body, the host copies ``.tolist()`` /
``.cpu()`` / ``.numpy()``, torch's global-generator draws, and the
static escapes of torch metadata, host-scalar annotations, type
queries and loops whose count is a shape or a pytree's structure.  Last,
``src/repro_torch`` lints clean, and a fault planted in a copy of a
layer body is found through the closure from ``core/fl_step.py``.
"""
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import prng, purity
from repro_torch.analysis.base import iter_py_files
from repro_torch.analysis.runner import run_analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _rules(violations):
    return [v.rule for v in violations]


def _src(code: str) -> str:
    return textwrap.dedent(code)


def _lint(code: str):
    return purity.check_file("fake/mod.py", _src(code))


# --- twins of the reference's cases -----------------------------------------

def test_purity_np_random_in_jitted_fn_fires():
    found = _lint("""
        import numpy as np
        import torch
        @torch.compile
        def step(x):
            return x + np.random.normal()
    """)
    assert _rules(found) == ["PURITY-NPRANDOM"]


def test_purity_branch_on_traced_value_fires():
    found = _lint("""
        import torch
        def step(x):
            if x > 0:
                return x
            return -x
        per_example = torch.func.vmap(step)
    """)
    assert _rules(found) == ["PURITY-BRANCH"]


def test_purity_clock_item_coerce_fire():
    found = _lint("""
        import time
        import torch
        from torch.utils.checkpoint import checkpoint
        def step(x):
            t = time.perf_counter()
            y = x.item()
            z = float(x)
            return t + y + z
        def run(x):
            return checkpoint(step, x, use_reentrant=False)
    """)
    assert sorted(_rules(found)) == ["PURITY-CLOCK", "PURITY-COERCE",
                                     "PURITY-ITEM"]


def test_purity_taint_propagates_through_assignment():
    found = _lint("""
        import torch
        @torch.compile
        def step(x):
            y = x * 2
            while y < 10:
                y = y + 1
            return y
    """)
    assert _rules(found) == ["PURITY-BRANCH"]


def test_purity_consumer_arg_and_maker_nesting_are_traced():
    found = _lint("""
        import numpy as np
        import torch

        def host_setup(n):
            return np.random.default_rng(n)     # host-side: fine

        def run(xs):
            def body(x):
                return float(x)                 # traced via vmap
            return torch.func.vmap(body)(xs)

        def make_train_step(n):
            def mask(t):
                return bool(t)                  # traced by convention
            return mask
    """)
    # host_setup's np.random never fires (host code); the vmap body's
    # float() and the make_train_step closure's bool() both do
    assert _rules(found) == ["PURITY-COERCE", "PURITY-COERCE"]
    assert any("body()" in v.message for v in found)
    assert any("mask()" in v.message for v in found)


def test_purity_static_escapes_stay_silent():
    """The four deliberate taint exceptions: a host-scalar annotation
    (the port's ``static_argnames``), cfg.*, shape metadata, and
    is-None / dict-membership tests."""
    found = _lint("""
        import torch
        import torch.nn.functional as F

        @torch.compile
        def step(cfg, x, lp, use_kernel: bool, window=None):
            if not use_kernel:
                return x
            b, s = x.shape
            pad = (-s) % 8
            if pad:
                x = F.pad(x, (0, pad))
            if cfg.family == "ssm":
                x = x * 2
            if window is not None:
                x = x + window
            if "bias" in lp:
                x = x + lp["bias"]
            return x
    """)
    assert found == []


def test_purity_cross_module_closure_fires():
    """check_files follows the module-alias attribute-call idiom
    (``attn.attend_full``-style) and from-imports into other analyzed
    files: impurities in the callee are flagged even though the callee's
    module has no traced roots of its own."""
    root = _src("""
        import torch
        from pkg.models import helper as hm
        from pkg.models.helper import leaf

        def step(x, w):
            y = hm.mix(x, w, 4)
            return leaf(y)

        grad_step = torch.func.grad(step)
    """)
    helper = _src("""
        import numpy as np

        def mix(q, k, width):
            if width > 2:        # static at every call site: clean
                q = q + k
            if q.sum() > 0:      # tainted via call-site seed
                q = -q
            return q

        def leaf(z):
            return z * np.random.rand()
    """)
    srcs = {"pkg/models/root.py": root, "pkg/models/helper.py": helper}
    found = purity.check_files(list(srcs), srcs)
    assert _rules(found) == ["PURITY-BRANCH", "PURITY-NPRANDOM"]
    assert all(v.path == "pkg/models/helper.py" for v in found)
    # the width > 2 branch did NOT fire: call-site seeding keeps static
    # config untainted in the callee
    assert len([v for v in found if v.rule == "PURITY-BRANCH"]) == 1
    # single-file analysis of the caller alone stays silent
    assert purity.check_files(["pkg/models/root.py"],
                              {"pkg/models/root.py": root}) == []


def test_purity_closure_follows_init_reexport():
    """One level of package ``__init__`` re-export resolution.  The
    callee's tainted loop is spelled as torch's host loop, a ``range``
    over a tensor (a loop over the tensor itself runs its shape's count
    of times: see ``test_loops_over_shapes_and_pytrees_stay_silent``)."""
    init = "from pkg.models.helper import mix\n"
    helper = _src("""
        def mix(q, k):
            for _ in range(q.sum()):   # tainted loop in the callee
                k = k + q
            return k
    """)
    use = _src("""
        import torch
        from pkg.models import mix

        @torch.compile
        def step(x):
            return mix(x, x)
    """)
    srcs = {"pkg/models/__init__.py": init,
            "pkg/models/helper.py": helper,
            "pkg/models/use.py": use}
    found = purity.check_files(list(srcs), srcs)
    assert _rules(found) == ["PURITY-BRANCH"]
    assert found[0].path == "pkg/models/helper.py"


def test_purity_kwonly_constant_default_is_static():
    """Keyword-only params with literal defaults are config knobs —
    branching on them in a traced function stays silent."""
    found = _lint("""
        import torch
        @torch.compile
        def step(x, *, window=None, chunk=128):
            if window is not None and chunk > 64:
                x = x[:chunk]
            flag = window is None
            if flag:
                x = x + 1
            return x
    """)
    assert found == []


# --- what torch traces or re-runs ---------------------------------------------

@pytest.mark.parametrize("consumer", [
    "checkpoint(body, x, use_reentrant=False)",
    "torch.utils.checkpoint.checkpoint(body, x)",
    "rematerialized(body)(x)",
])
def test_checkpointed_body_is_traced(consumer):
    """A checkpointed body runs again in backward: a host copy there
    syncs twice, and the port's ``rematerialized`` is a consumer too."""
    found = _lint(f"""
        import torch
        from torch.utils.checkpoint import checkpoint
        from repro_torch.models.transformer import rematerialized

        def body(x):
            n = x.tolist()
            return x * len(n)

        def run(x):
            return {consumer}
    """)
    assert _rules(found) == ["PURITY-ITEM"]
    assert ".tolist()" in found[0].message


@pytest.mark.parametrize("decorator", [
    "@my_op.register_fake",
    '@torch.library.register_fake("ns::my_op")',
])
def test_register_fake_body_is_traced(decorator):
    """A custom op's fake implementation runs on fake tensors, which
    have no values: a branch on one, or a host copy, fails there."""
    found = _lint(f"""
        import torch

        {decorator}
        def _(x, n):
            if x.sum() > 0:
                return x.new_empty(x.shape)
            return x.cpu()
    """)
    assert _rules(found) == ["PURITY-BRANCH", "PURITY-ITEM"]


def test_closure_stops_at_a_custom_ops_body():
    """The op's body and its launcher (which the wrapper also calls
    directly on a plain CUDA tensor) are opaque to tracing; the traced
    wrapper itself is still linted, across modules too."""
    kernel = _src("""
        import time

        def launch(x):
            t0 = time.perf_counter()
            n = int(x.numel())
            return x.new_empty(x.shape), x.sum().item(), t0, n
    """)
    ops = _src("""
        import torch
        from pkg.kernels.kernel import launch

        @torch.library.custom_op("ns::op", mutates_args=())
        def op(x: torch.Tensor) -> torch.Tensor:
            return launch(x)[0]

        @op.register_fake
        def _(x):
            return x.new_empty(x.shape)

        def wrapper(x):
            if type(x) is torch.Tensor:
                return launch(x)[0]
            return torch.ops.ns.op(x)
    """)
    user = _src("""
        import torch
        from pkg.kernels import ops

        def loss(x):
            return ops.wrapper(x).sum()

        g = torch.func.grad(loss)
    """)
    srcs = {"pkg/kernels/kernel.py": kernel, "pkg/kernels/ops.py": ops,
            "pkg/models/user.py": user}
    assert purity.check_files(list(srcs), srcs) == []
    planted = dict(srcs)
    planted["pkg/kernels/ops.py"] = ops.replace(
        "    if type(x) is torch.Tensor:",
        "    x.numpy()\n    if type(x) is torch.Tensor:")
    found = purity.check_files(list(planted), planted)
    assert _rules(found) == ["PURITY-ITEM"]
    assert found[0].path == "pkg/kernels/ops.py"


@pytest.mark.parametrize("call", ["x.item()", "x.tolist()", "x.cpu()",
                                  "x.numpy()"])
def test_host_copies_fire(call):
    found = _lint(f"""
        import torch
        def f(x):
            return {call}
        g = torch.func.vmap(f)
    """)
    assert _rules(found) == ["PURITY-ITEM"]


@pytest.mark.parametrize("draw", ["torch.randn(x.shape)",
                                  "torch.rand_like(x)",
                                  "x.new_empty(x.shape).normal_()",
                                  "torch.nn.functional.dropout(x, 0.1)",
                                  "random.random()"])
def test_stateful_rng_draws_fire(draw):
    """A draw from a global generator gives other numbers on a rerun:
    the port's bodies draw from addressed keys (``repro_torch.prng``)."""
    found = _lint(f"""
        import random
        import torch
        from torch.utils.checkpoint import checkpoint
        def body(x):
            return x + {draw}
        def run(x):
            return checkpoint(body, x, use_reentrant=False)
    """)
    assert _rules(found) == ["PURITY-NPRANDOM"]


def test_torch_metadata_and_type_queries_stay_silent():
    found = _lint("""
        import torch
        from repro_torch.kernels.tick_fused.ops import on_cuda

        @torch.compile
        def step(x, tree):
            if x.device.type == "cuda" or x.is_cuda or on_cuda(x):
                x = x * 2
            if x.requires_grad and torch.is_grad_enabled():
                x = x + 1
            if x.layout == torch.strided and x.dim() == 2:
                x = x[: x.numel() // 2]
            if isinstance(tree, dict) and len(tree) > 1:
                x = x + 3
            if not any(isinstance(l, torch.Tensor) for l in tree.values()):
                x = x - 1
            return x
    """)
    assert found == []


def test_host_scalar_annotations_stay_silent():
    """``pos: int`` / ``Optional[float]``: host scalars by the
    signature's contract, as the port's decode and FL step declare."""
    found = _lint("""
        from typing import Optional
        import torch

        def make_serve_step(cfg):
            def serve_step(params, cache, tokens, pos: int,
                           eta: Optional[float] = None):
                pos = int(pos)
                if eta is not None and float(eta) > 0:
                    pos = pos + 1
                return cache[:, pos]
            return serve_step
    """)
    assert found == []
    unannotated = _lint("""
        def make_serve_step(cfg):
            def serve_step(params, cache, tokens, pos):
                return cache[:, int(pos)]
            return serve_step
    """)
    assert _rules(unannotated) == ["PURITY-COERCE"]


def test_loops_over_shapes_and_pytrees_stay_silent():
    """A loop over a tensor or a pytree runs its shape's or structure's
    count of times; ``range`` over a tensor reads it on the host."""
    found = _lint("""
        import torch

        @torch.compile
        def step(q, tree, n):
            for row in q:
                tree = tree + row
            for i, (k, v) in enumerate(zip(tree, q)):
                q = q + v
            for lo in range(0, q.shape[0], 4):
                q = q * 2
            for _ in range(n):
                q = q + 1
            return q
    """)
    assert _rules(found) == ["PURITY-BRANCH"]
    assert found[0].line == 12
    assert "range" in found[0].message


@pytest.mark.parametrize("test,fires", [
    ("n_shards > 1 and pods is not None", False),
    ("pods is not None and x > 0", True),
    ("not (pods is None)", False),
    ("not x.any()", True),
])
def test_boolean_tests_are_tainted_by_their_operands(test, fires):
    """``a and b`` / ``not a`` is tainted where an operand is: an
    ``is None`` test beside a closure constant stays silent."""
    found = _lint(f"""
        import torch

        def make_train_step(n_shards):
            def train_step(x, pods):
                if {test}:
                    x = x + 1
                return x
            return train_step
    """)
    assert _rules(found) == (["PURITY-BRANCH"] if fires else [])


def test_cuda_graph_capture_is_traced():
    """The statements of a ``with torch.cuda.graph(...)`` block, and the
    functions it calls, are captured; ``make_graphed_callables`` traces
    its callable."""
    found = _lint("""
        import time
        import torch

        def tick(x):
            return x.item()

        def plan(x):
            if x.sum() > 0:
                return x
            return -x

        def capture(g, x):
            with torch.cuda.graph(g):
                y = tick(x)
                t = time.time()
            return torch.cuda.make_graphed_callables(plan, (x,)), y, t
    """)
    assert sorted(_rules(found)) == ["PURITY-BRANCH", "PURITY-CLOCK",
                                     "PURITY-ITEM"]


def test_reference_makers_run_eagerly_in_the_port():
    """``tick_plan`` / ``block_body`` / ``_build_segment`` closures run
    eagerly here (one host sync a tick by design) until a CUDA graph
    captures the tick: not traced.  The three ``fl_step`` builders'
    closures are."""
    for maker, fires in (("tick_plan", False), ("block_body", False),
                         ("_build_segment", False),
                         ("make_train_step", True),
                         ("make_serve_step", True),
                         ("make_prefill_step", True)):
        found = _lint(f"""
            def {maker}(n):
                def inner(t):
                    return t.item()
                return inner
        """)
        assert _rules(found) == (["PURITY-ITEM"] if fires else []), maker


# --- the port's own tree -------------------------------------------------------

def test_purity_repo_is_clean():
    files = iter_py_files([PORT])
    assert files, "expected the port's sources"
    assert purity.check_files(files) == []
    assert prng.check_files(files) == []


@pytest.mark.parametrize("module,anchor,plant,rule", [
    # a layer body, reached from fl_step's train step through model ->
    # transformer (a checkpointed body there)
    ("models/transformer.py", "    aux = torch.zeros((), dtype=F32, "
     'device=x.device)\n    h = apply_norm(cfg, x, lp["ln1"])\n',
     "    torch.cuda.synchronize(x.tolist())\n", "PURITY-ITEM"),
    # the SSD mixer, reached through the layer body
    ("models/ssm.py", "    B_, S, _ = x.shape\n",
     "    B_ = int(x.sum())\n", "PURITY-COERCE"),
    # the loss chunk, a checkpointed body of its own
    ("models/transformer.py", "        m = m_c.to(F32)\n",
     "        m = m * np.random.rand()\n", "PURITY-NPRANDOM"),
    # the flash attention launcher: behind the custom op, opaque
    ("kernels/flash_attention/kernel.py", "    KV = k.shape[2]\n",
     "    KV = int(k.sum().item())\n", None),
])
def test_planted_fault_is_found_through_the_closure(module, anchor, plant,
                                                    rule):
    """A fault planted in a copy of one port module (the others as they
    are) is found, or not, through the closure from the dry run's
    traced step closures."""
    files = iter_py_files([PORT])
    srcs = {p: open(p).read() for p in files}
    path = os.path.join(PORT, module)
    assert srcs[path].count(anchor) == 1
    srcs[path] = srcs[path].replace(anchor, anchor + plant)
    found = purity.check_files(files, srcs)
    assert _rules(found) == ([rule] if rule else [])
    assert all(v.path == path for v in found)


def test_runner_reports_purity():
    """``run_analysis`` runs PURITY-* beside the other families, and the
    CLI reports the port clean with an empty baseline."""
    all_v, new_v = run_analysis([PORT], structure=False)
    assert all_v == new_v == []
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", PORT,
         "--no-structure"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "file(s) clean" in out.stdout
