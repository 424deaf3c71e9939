"""Traced-code purity lint (rule family PURITY-*), the port's copy of
``repro.analysis.purity`` spelled for what torch traces or re-runs.

The reference's jit traces Python once and replays compiled XLA.  The
port has regions of the same kind: ``torch.func`` transforms trace their
function (``dp.mechanism``'s ``vmap(grad_and_value(...))``), the dry run
runs ``core.fl_step``'s step closures under ``FakeTensorMode`` (where
the reference jits the same functions), a checkpointed layer body runs
a second time in backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``), and ``torch.cuda.graph`` / ``torch.compile``
capture what they are given.  Anything host-side inside one either
fails there (a fake tensor has no value), syncs the card, or gives other
bits on the rerun.  This pass finds those functions statically and flags
host-world constructs inside them:

  PURITY-NPRANDOM   stateful RNG draws: ``np.random.*``, Python's
                    ``random.*``, torch's global-generator draws
                    (``torch.rand`` / ``randn`` / ``randint`` / ...,
                    ``.normal_()``): a rerun draws other numbers (the
                    port's bodies take keys, ``repro_torch.prng``)
  PURITY-CLOCK      ``time.time`` / ``perf_counter`` / ``datetime.now``
  PURITY-ITEM       a device→host copy: ``.item()``, ``.tolist()``,
                    ``.cpu()``, ``.numpy()``
  PURITY-COERCE     ``float(x)`` / ``int(x)`` / ``bool(x)`` on a
                    non-constant (host coercion of a traced value)
  PURITY-BRANCH     Python ``if`` / ``while`` / ``for`` / ``assert``
                    whose condition derives from a traced argument
                    (use ``torch.where``; branching on closure
                    constants is fine)

Traced functions are found structurally, function by function (the
engine modules mix host-side setup with traced closures):

  * decorated with ``@torch.compile`` or ``@<op>.register_fake`` /
    ``@torch.library.register_fake(...)`` (a custom op's fake
    implementation runs on fake tensors),
  * passed (by name or as a lambda) to a tracing consumer:
    ``torch.func.vmap`` / ``grad`` / ``grad_and_value`` / ``vjp`` /
    ``jvp`` / ``jacrev`` / ``jacfwd`` / ``hessian`` /
    ``functional_call``, ``torch.utils.checkpoint.checkpoint`` (and
    ``rematerialized``, the port's ``jax.checkpoint``),
    ``register_fake``, ``torch.cuda.make_graphed_callables``,
    ``torch.compile``,
  * called inside a ``with torch.cuda.graph(...)`` block (and the
    block's own statements, linted as one function),
  * nested inside a traced-closure factory (``TRACED_MAKERS``: the three
    ``core.fl_step`` builders, whose closures the dry run traces).  The
    reference's makers ``tick_plan`` / ``block_body`` /
    ``_build_segment`` run eagerly in the port, one host sync a tick by
    design; they join the set when the tick is captured as a CUDA graph
    (ROADMAP Queue 2 [9]),
  * or nested inside / called by name from any of the above
    (same-module transitive closure).

A custom op's own body (``@torch.library.custom_op``) is opaque to
tracing: fake tensors, DTensor and the flop counter go through the op,
not into it.  So the closure stops there: the op's body, and the
functions it calls (its launcher, which the op's wrapper also calls
directly on a plain CUDA tensor), are not linted as traced.

``check_files`` additionally closes over *cross-module* calls: when a
traced function calls ``attn.attend_full(...)`` through a module alias
(``from repro_torch.models import attention as attn``) or
``chunked_loss(...)`` through a from-import, and the target module is
part of the analyzed set, the callee is linted as traced too.  The
callee's taint is seeded from the call site — only parameters actually
bound to tainted caller expressions start tainted — so static config
threaded alongside tensors (window sizes, flags) does not trip
PURITY-BRANCH.  Seeds accumulate to a fixpoint across call sites;
package ``__init__`` re-exports are followed one level.

Taint for PURITY-BRANCH is a single forward pass: the traced function's
parameters are tainted, and a name assigned from an expression that
mentions a tainted name becomes tainted.  Closure constants never
taint.

Deliberate taint exceptions (each is static at trace time):

  * config-object params (``cfg`` / ``config`` / ``hparams`` — plain
    dataclasses, never tensors),
  * keyword-only params with a literal default (window sizes, flags),
  * tensor *metadata* (``.shape`` / ``.ndim`` / ``.dtype`` / ``.size``
    / ``.dim()`` / ``.numel()``, and torch's ``.device`` / ``.is_cuda``
    / ``.requires_grad`` / ``.layout``) and everything derived from it,
  * ``is (not) None`` identity tests and ``in`` dict-membership tests
    on parameter pytrees.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.analysis.base import Violation

#: functions whose nested defs are traced by repo convention: the dry
#: run traces the step closures they build (see the module docstring)
TRACED_MAKERS = {"make_train_step", "make_serve_step", "make_prefill_step"}

#: callables whose function-valued arguments get traced
TRACING_CONSUMERS = {"vmap", "grad", "grad_and_value", "vjp", "jvp",
                     "jacrev", "jacfwd", "hessian", "functional_call",
                     "checkpoint", "rematerialized", "register_fake",
                     "make_graphed_callables", "compile"}

#: decorators that make the decorated function traced
TRACING_DECORATORS = {"compile", "register_fake"}

#: decorators whose function is a custom op's body: opaque to tracing
OPAQUE_DECORATORS = {"custom_op"}

#: context managers whose block is captured (``torch.cuda.graph``)
CAPTURE_CONTEXTS = {"graph"}

CLOCK_CALLS = {"time", "perf_counter", "monotonic", "process_time",
               "now", "clock_gettime"}

#: torch's draws from a global generator (module functions and in-place
#: tensor methods)
TORCH_RNG_CALLS = {"rand", "randn", "randint", "randperm", "rand_like",
                   "randn_like", "randint_like", "normal", "bernoulli",
                   "multinomial", "poisson", "dropout"}
TORCH_RNG_METHODS = {"normal_", "uniform_", "random_", "bernoulli_",
                     "exponential_", "geometric_", "log_normal_",
                     "cauchy_"}

#: methods that copy a tensor's values to the host
HOST_COPY_METHODS = {"item", "tolist", "cpu", "numpy"}

#: attribute accesses (and metadata methods) that yield static
#: trace-time metadata, not traced values — shape-derived padding
#: arithmetic and device dispatch stay untainted
STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "dim", "numel",
                "device", "is_cuda", "requires_grad", "layout"}

#: calls that yield trace-time Python whatever their arguments: type and
#: structure queries, and the port's device / tensor-subclass queries
STATIC_CALLS = {"isinstance", "type", "hasattr", "callable", "len",
                "is_tensor", "is_grad_enabled", "on_cuda", "_is_dtensor"}

#: parameter names that are config dataclasses by repo convention —
#: branching on their fields is the static model-family dispatch
CONFIG_PARAMS = {"cfg", "config", "hparams"}

#: annotations that declare a parameter a host scalar — the port's
#: spelling of the reference's ``static_argnames``
HOST_SCALAR_TYPES = {"int", "float", "bool", "str"}

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]


def _attr_last(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _attr_chain(node: ast.expr) -> List[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def _decorated(dec: ast.expr, names: Set[str]) -> bool:
    """``@x.name``, ``@x.name(...)`` or ``@partial(x.name, ...)`` for a
    ``name`` in ``names``."""
    if _attr_last(dec) in names:
        return True
    if isinstance(dec, ast.Call):
        fn = _attr_last(dec.func)
        if fn in names:
            return True
        if fn == "partial" and dec.args \
                and _attr_last(dec.args[0]) in names:
            return True
    return False


def _is_opaque(fn: "FuncNode") -> bool:
    return any(_decorated(d, OPAQUE_DECORATORS)
               for d in getattr(fn, "decorator_list", []))


class _FuncIndex(ast.NodeVisitor):
    """Collect every function def with its parent chain."""

    def __init__(self):
        self.funcs: List[FuncNode] = []
        self.parent: Dict[FuncNode, Optional[FuncNode]] = {}
        self.by_name: Dict[str, List[FuncNode]] = {}
        self._stack: List[FuncNode] = []

    def _enter(self, node: FuncNode) -> None:
        self.funcs.append(node)
        self.parent[node] = self._stack[-1] if self._stack else None
        name = getattr(node, "name", None)
        if name:
            self.by_name.setdefault(name, []).append(node)
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _enter
    visit_AsyncFunctionDef = _enter
    visit_Lambda = _enter


def _capture_blocks(tree: ast.Module) -> List[ast.FunctionDef]:
    """Each ``with torch.cuda.graph(...)`` block's statements as one
    function without parameters (its own line), to lint as captured."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call)
                and _attr_last(it.context_expr.func) in CAPTURE_CONTEXTS
                for it in node.items):
            fn = ast.FunctionDef(
                name="<captured block>",
                args=ast.arguments(posonlyargs=[], args=[], vararg=None,
                                   kwonlyargs=[], kw_defaults=[],
                                   kwarg=None, defaults=[]),
                body=node.body, decorator_list=[], returns=None,
                type_params=[])
            ast.copy_location(fn, node)
            out.append(fn)
    return out


def _opaque(index: _FuncIndex) -> Set[FuncNode]:
    """Custom ops' bodies and the functions of this module they call by
    name (their launchers): tracing goes through the op, not into it."""
    out: Set[FuncNode] = set()
    for fn in index.funcs:
        if not _is_opaque(fn):
            continue
        out.add(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Name):
                out.update(index.by_name.get(node.func.id, []))
    return out


def _traced_roots(tree: ast.Module, index: _FuncIndex,
                  captured: List[ast.FunctionDef]) -> Set[FuncNode]:
    roots: Set[FuncNode] = set(captured)
    for fn in index.funcs:
        # decorator-based: @torch.compile, @<op>.register_fake
        for dec in getattr(fn, "decorator_list", []):
            if _decorated(dec, TRACING_DECORATORS):
                roots.add(fn)
        # nested inside a traced-closure factory
        p = index.parent[fn]
        while p is not None:
            if getattr(p, "name", None) in TRACED_MAKERS:
                roots.add(fn)
                break
            p = index.parent[p]
    # consumer-call based: vmap(f), checkpoint(f, x), register_fake(op,
    # f); and the calls by name inside a captured block
    calls = [(node, node.args + [kw.value for kw in node.keywords])
             for node in ast.walk(tree) if isinstance(node, ast.Call)
             and _attr_last(node.func) in TRACING_CONSUMERS]
    calls += [(node, [node.func]) for blk in captured for st in blk.body
              for node in ast.walk(st) if isinstance(node, ast.Call)]
    for _, args in calls:
        for arg in args:
            if isinstance(arg, ast.Lambda):
                roots.add(arg)
            elif isinstance(arg, ast.Name):
                roots.update(index.by_name.get(arg.id, []))
    return roots


def _transitive(roots: Set[FuncNode], index: _FuncIndex,
                opaque: Set[FuncNode]) -> Set[FuncNode]:
    """Roots + functions they call by bare name + their nested defs,
    stopping at custom ops' bodies and launchers."""
    traced = set(roots) - opaque
    frontier = list(traced)
    while frontier:
        fn = frontier.pop()
        for node in ast.walk(fn):
            callee = None
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Name):
                callee = node.func.id
            if callee:
                for cand in index.by_name.get(callee, []):
                    if cand not in traced and cand not in opaque:
                        traced.add(cand)
                        frontier.append(cand)
            if node is not fn and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node not in traced and node not in opaque:
                    traced.add(node)
                    frontier.append(node)
    return traced


def _params(fn: FuncNode) -> Set[str]:
    a = fn.args
    names = [p.arg for p in list(a.posonlyargs) + list(a.args)]
    # keyword-only params with literal defaults are static config knobs
    # by repo convention (window sizes, boolean flags) — branching on
    # them is the trace-time specialization the model code relies on
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None and isinstance(d, ast.Constant):
            continue
        names.append(p.arg)
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    host = {p.arg for p in list(a.posonlyargs) + list(a.args)
            + list(a.kwonlyargs) if _host_scalar(p.annotation)}
    return {n for n in names
            if n != "self" and n not in CONFIG_PARAMS and n not in host}


def _host_scalar(ann: Optional[ast.expr]) -> bool:
    """``int`` / ``float`` / ``bool`` / ``str``, as a name, a string or
    inside ``Optional[...]``."""
    if isinstance(ann, ast.Name):
        return ann.id in HOST_SCALAR_TYPES
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value in HOST_SCALAR_TYPES
    if isinstance(ann, ast.Subscript) and _attr_last(ann.value) == "Optional":
        return _host_scalar(ann.slice)
    return False


_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                   ast.DictComp)


def _names_in(expr: ast.expr) -> Set[str]:
    """Names that carry taint — skips static-metadata attribute reads
    (``x.shape`` mentions ``x`` but yields trace-time Python) and
    ``STATIC_CALLS``; a comprehension carries its iterable's names only
    where its elements use the loop variable (the loop's length is
    structure: shapes and pytrees)."""
    out: Set[str] = set()

    def walk(node: ast.AST) -> None:
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return
            walk(node.value)
            return
        if isinstance(node, ast.Call) and _attr_last(node.func) \
                in STATIC_CALLS:
            return
        if isinstance(node, _COMPREHENSIONS):
            out.update(_comprehension_names(node))
            return
        if isinstance(node, ast.Name):
            out.add(node.id)
            return
        for c in ast.iter_child_nodes(node):
            walk(c)

    walk(expr)
    return out


def _comprehension_names(node) -> Set[str]:
    elts = ([node.key, node.value] if isinstance(node, ast.DictComp)
            else [node.elt])
    elts += [c for g in node.generators for c in g.ifs]
    inner = set().union(*map(_names_in, elts))
    for g in reversed(node.generators):
        targets = _names_in(g.target)
        if inner & targets:
            inner |= _names_in(g.iter)
        inner -= targets
    return inner


def _test_is_static(expr: ast.expr) -> bool:
    """True when a branch test is decidable at trace time regardless of
    taint: ``is (not) None`` identity and ``in`` dict-membership checks
    (the repo's optional-arg and params-pytree idioms)."""
    if isinstance(expr, ast.BoolOp):
        return all(_test_is_static(v) for v in expr.values)
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not):
        return _test_is_static(expr.operand)
    if isinstance(expr, ast.Compare):
        return all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in expr.ops)
    return False


def _stateful_rng(chain: List[str]) -> bool:
    """``np.random.*``, ``random.*``, ``torch.rand*`` & co., and the
    in-place draws ``x.normal_()`` & co."""
    if len(chain) >= 2 and chain[-2] == "random" \
            and chain[0] in ("np", "numpy", "random"):
        return True
    if len(chain) >= 2 and chain[0] == "torch" \
            and chain[-1] in TORCH_RNG_CALLS:
        return True
    return bool(chain) and chain[-1] in TORCH_RNG_METHODS


def _check_traced_fn(fn: FuncNode, path: str,
                     seed: Optional[Set[str]] = None
                     ) -> "Tuple[List[Violation], Set[str]]":
    """Lint one traced function; returns (violations, final taint set).

    With ``seed=None`` every non-static parameter starts tainted (the
    local-root case).  A seed set — from cross-module call-site binding
    — restricts the initial taint to the parameters actually fed traced
    values by some caller.
    """
    out: List[Violation] = []
    label = getattr(fn, "name", "<lambda>")
    if seed is None:
        tainted = _params(fn)
    else:
        tainted = set(seed) & _params(fn)

    def is_tainted(expr: ast.expr) -> bool:
        return bool(_names_in(expr) & tainted)

    def test_tainted(expr: ast.expr) -> bool:
        # ``a and b`` / ``not a``: tainted where an operand is
        if isinstance(expr, ast.BoolOp):
            return any(test_tainted(v) for v in expr.values)
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not):
            return test_tainted(expr.operand)
        return not _test_is_static(expr) and is_tainted(expr)

    body = fn.body if isinstance(fn.body, list) else [ast.Expr(fn.body)]
    stmts: List[ast.stmt] = list(body)
    while stmts:
        st = stmts.pop(0)
        # don't descend into nested defs: they are traced functions of
        # their own (handled separately) with their own parameter taint
        children = [c for c in ast.iter_child_nodes(st)
                    if not isinstance(c, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.Lambda))]
        for node in children:
            if isinstance(node, ast.stmt):
                stmts.append(node)
        # taint propagation — a value that is itself a static test
        # (``flag = x is None``) yields trace-time Python, not an array
        if isinstance(st, ast.Assign) and not _test_is_static(st.value) \
                and is_tainted(st.value):
            for t in st.targets:
                tainted.update(_names_in(t))
        if isinstance(st, (ast.AugAssign, ast.AnnAssign)) \
                and st.value is not None \
                and not _test_is_static(st.value) and is_tainted(st.value):
            tainted.update(_names_in(st.target))
        # host-branching on traced values
        if isinstance(st, (ast.If, ast.While)) and test_tainted(st.test):
            out.append(Violation(
                "PURITY-BRANCH", path, st.lineno,
                f"Python {type(st).__name__.lower()} on traced value in "
                f"{label}() — use torch.where"))
        if isinstance(st, ast.Assert) and test_tainted(st.test):
            out.append(Violation(
                "PURITY-BRANCH", path, st.lineno,
                f"assert on traced value in {label}()"))
        # a loop over a tensor or a pytree runs its shape's or its
        # structure's count of times; ``range(t)`` reads ``t`` on the host
        if isinstance(st, ast.For) and is_tainted(st.iter):
            tainted.update(_names_in(st.target))
            if any(isinstance(n, ast.Call) and _attr_last(n.func) == "range"
                   and any(is_tainted(a) for a in n.args)
                   for n in ast.walk(st.iter)):
                out.append(Violation(
                    "PURITY-BRANCH", path, st.lineno,
                    f"Python for over a range of a traced value in "
                    f"{label}() — loop over a static bound"))
        # expression-level checks within this statement
        for node in ast.walk(st):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.IfExp) and test_tainted(node.test):
                out.append(Violation(
                    "PURITY-BRANCH", path, node.lineno,
                    f"ternary on traced value in {label}() — use "
                    f"torch.where"))
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            method = (node.func.attr
                      if isinstance(node.func, ast.Attribute) else None)
            if _stateful_rng(chain):
                out.append(Violation(
                    "PURITY-NPRANDOM", path, node.lineno,
                    f"{'.'.join(chain)} in traced {label}() — a "
                    f"stateful draw differs on a rerun; draw from an "
                    f"addressed key (repro_torch.prng)"))
            elif len(chain) >= 2 and chain[0] in ("time", "datetime") \
                    and chain[-1] in CLOCK_CALLS:
                out.append(Violation(
                    "PURITY-CLOCK", path, node.lineno,
                    f"{'.'.join(chain)} in traced {label}() — wall "
                    f"clock cannot cross into traced code"))
            elif method in HOST_COPY_METHODS and not node.args \
                    and not node.keywords:
                out.append(Violation(
                    "PURITY-ITEM", path, node.lineno,
                    f".{method}() in traced {label}() — host sync inside "
                    f"the trace"))
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in ("float", "int", "bool") \
                    and node.args \
                    and not isinstance(node.args[0], ast.Constant) \
                    and is_tainted(node.args[0]):
                out.append(Violation(
                    "PURITY-COERCE", path, node.lineno,
                    f"{node.func.id}() on traced value in {label}() — "
                    f"host coercion forces a sync"))
    return out, tainted


class _ModuleInfo:
    """One analyzed file: its AST, traced set, and import bindings."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.index = _FuncIndex()
        self.index.visit(tree)
        self.opaque = _opaque(self.index)
        self.traced = _transitive(
            _traced_roots(tree, self.index, _capture_blocks(tree)),
            self.index, self.opaque)
        # dotted-name parts for suffix matching:
        # src/repro_torch/models/mlp.py -> ("src", "repro_torch",
        # "models", "mlp")
        parts = path.replace("\\", "/").split("/")
        if parts and parts[-1].endswith(".py"):
            parts[-1] = parts[-1][:-3]
        self.parts = tuple(p for p in parts if p not in ("", "."))
        # local name -> dotted module (import a.b as x / from a import b)
        self.mod_aliases: Dict[str, str] = {}
        # local name -> (dotted module, original name) for from-imports
        self.from_names: Dict[str, "Tuple[str, str]"] = {}
        pkg = self.parts[:-1]
        if self.parts and self.parts[-1] == "__init__":
            pkg = self.parts[:-2] + self.parts[-2:-1]
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for al in node.names:
                    if al.asname:
                        self.mod_aliases[al.asname] = al.name
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:       # relative: anchor at this package
                    up = pkg[:len(pkg) - (node.level - 1)] if node.level > 1 \
                        else pkg
                    base = ".".join(up) + ("." + base if base else "")
                for al in node.names:
                    local = al.asname or al.name
                    if al.name == "*":
                        continue
                    # could be a submodule or a name in `base` — record
                    # both; resolution tries module-suffix first
                    self.mod_aliases.setdefault(
                        local, f"{base}.{al.name}" if base else al.name)
                    self.from_names[local] = (base, al.name)

    def top_level_fn(self, name: str) -> Optional[FuncNode]:
        cands = self.index.by_name.get(name, [])
        for f in cands:
            if self.index.parent[f] is None:
                return f
        return cands[0] if cands else None


def _resolve_module(dotted: str, modules: "List[_ModuleInfo]"
                    ) -> Optional[_ModuleInfo]:
    """Find the analyzed file whose path ends with the dotted module
    (``repro_torch.models.attention`` matches
    src/repro_torch/models/attention.py,
    and a package name matches its ``__init__.py``)."""
    want = tuple(dotted.split("."))
    for m in modules:
        if m.parts[-len(want):] == want:
            return m
        if m.parts[-1] == "__init__" and len(m.parts) > len(want) \
                and m.parts[-len(want) - 1:-1] == want:
            return m
    return None


def _resolve_call(info: _ModuleInfo, call: ast.Call,
                  modules: "List[_ModuleInfo]", _depth: int = 0
                  ) -> "Optional[Tuple[_ModuleInfo, FuncNode]]":
    """Map a call in ``info`` to a function def in another analyzed
    file, following module aliases, from-imports, and (one level)
    package ``__init__`` re-exports; None at a custom op's body or
    launcher (opaque to tracing)."""
    chain = _attr_chain(call.func)
    target: "Optional[Tuple[str, str]]" = None
    if len(chain) >= 2 and chain[0] in info.mod_aliases:
        mod = info.mod_aliases[chain[0]]
        if len(chain) > 2:
            mod = mod + "." + ".".join(chain[1:-1])
        target = (mod, chain[-1])
    elif len(chain) == 1 and chain[0] in info.from_names:
        target = info.from_names[chain[0]]
    if target is None:
        return None
    mod, name = target
    tinfo = _resolve_module(mod, modules)
    if tinfo is None or tinfo is info:
        return None
    fn = tinfo.top_level_fn(name)
    if fn is not None:
        return None if fn in tinfo.opaque else (tinfo, fn)
    # package __init__ re-export: follow `from X import name` one level
    if _depth == 0 and name in tinfo.from_names:
        sub, orig = tinfo.from_names[name]
        sinfo = _resolve_module(sub, modules)
        if sinfo is not None and sinfo is not info:
            sfn = sinfo.top_level_fn(orig)
            if sfn is not None and sfn not in sinfo.opaque:
                return sinfo, sfn
    return None


def _seed_from_call(call: ast.Call, callee: FuncNode,
                    caller_tainted: Set[str]) -> Set[str]:
    """Callee params bound to tainted caller expressions at this site."""
    a = callee.args
    pos = [p.arg for p in list(a.posonlyargs) + list(a.args)]
    seed: Set[str] = set()

    def hot(expr: ast.expr) -> bool:
        return bool(_names_in(expr) & caller_tainted)

    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            if hot(arg.value):      # can't bind positions — taint rest
                seed.update(pos[i:])
            break
        if hot(arg):
            seed.add(pos[i] if i < len(pos)
                     else (a.vararg.arg if a.vararg else pos[-1] if pos
                           else ""))
    kw_ok = set(pos) | {p.arg for p in a.kwonlyargs}
    for kw in call.keywords:
        if kw.arg is None:          # **expansion: conservatively all
            if hot(kw.value):
                seed.update(kw_ok)
        elif hot(kw.value):
            seed.add(kw.arg if kw.arg in kw_ok
                     else (a.kwarg.arg if a.kwarg else kw.arg))
    seed.discard("")
    return seed


def _cross_call_seeds(info: _ModuleInfo, fn: FuncNode, tainted: Set[str],
                      modules: "List[_ModuleInfo]"
                      ) -> "List[Tuple[_ModuleInfo, FuncNode, Set[str]]]":
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        hit = _resolve_call(info, node, modules)
        if hit is None:
            continue
        tinfo, tfn = hit
        out.append((tinfo, tfn, _seed_from_call(node, tfn, tainted)))
    return out


def check_file(path: str, source: Optional[str] = None) -> List[Violation]:
    """Single-file lint (no cross-module closure)."""
    return check_files([path], {path: source} if source is not None
                       else None)


def check_files(paths: Sequence[str],
                sources: Optional[Dict[str, str]] = None
                ) -> List[Violation]:
    out: List[Violation] = []
    modules: List[_ModuleInfo] = []
    for p in paths:
        src = (sources or {}).get(p)
        if src is None:
            src = open(p).read()
        try:
            tree = ast.parse(src, filename=p)
        except SyntaxError as e:
            out.append(Violation("PURITY-PARSE", p, e.lineno or 0,
                                 f"cannot parse: {e.msg}"))
            continue
        modules.append(_ModuleInfo(p, tree))
    # a custom op's launcher may live in another module (its kernel.py)
    for info in modules:
        for fn in [f for f in info.index.funcs if _is_opaque(f)]:
            for node in ast.walk(fn):
                hit = (_resolve_call(info, node, modules)
                       if isinstance(node, ast.Call) else None)
                if hit is not None:
                    hit[0].opaque.add(hit[1])

    # phase 1: per-file roots, full-param taint; collect cross-module
    # call seeds from every traced function's final taint
    seeds: Dict["Tuple[int, int]", Set[str]] = {}
    nodes: Dict["Tuple[int, int]", "Tuple[_ModuleInfo, FuncNode]"] = {}
    work: List["Tuple[int, int]"] = []

    def absorb(edges) -> None:
        for tinfo, tfn, seed in edges:
            if tfn in tinfo.traced:
                continue            # already linted with full taint
            key = (id(tinfo), id(tfn))
            nodes[key] = (tinfo, tfn)
            have = seeds.setdefault(key, set())
            if not have >= seed:
                have |= seed
                if key not in work:
                    work.append(key)

    for info in modules:
        for fn in sorted(info.traced, key=lambda f: f.lineno):
            viols, tainted = _check_traced_fn(fn, info.path)
            out.extend(viols)
            absorb(_cross_call_seeds(info, fn, tainted, modules))

    # phase 2: fixpoint over call-site-seeded callees
    cross: Dict["Tuple[int, int]", List[Violation]] = {}
    while work:
        key = work.pop(0)
        tinfo, tfn = nodes[key]
        viols, tainted = _check_traced_fn(tfn, tinfo.path,
                                          seed=seeds[key])
        cross[key] = viols          # replace: seeds only grow
        absorb(_cross_call_seeds(tinfo, tfn, tainted, modules))
    for key in sorted(cross, key=lambda k: (nodes[k][0].path,
                                            nodes[k][1].lineno)):
        out.extend(cross[key])
    # a nested def's body is also walked by each function that encloses
    # it: report each (rule, line) once
    once: Dict["Tuple[str, str, int]", Violation] = {}
    for v in out:
        once.setdefault((v.rule, v.path, v.line), v)
    return list(once.values())
