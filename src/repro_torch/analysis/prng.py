"""PRNG address-space auditor (rule family PRNG-*).

Collects every PRNG key-creation call — the port's ``prng.PRNGKey``
and ``numpy.random.default_rng``, in any import spelling — whose seed
expression XORs in a salt, and checks the salt against the central
registry (``repro_torch.analysis.salts``):

  PRNG-UNDECLARED  raw integer salt literal (``PRNGKey(seed ^ 0x5BEED)``)
                   — register it in repro_torch.analysis.salts and
                   import it
  PRNG-UNKNOWN     a ``*_SALT``-style name that is not in the registry
  PRNG-LOCAL       a registered salt name bound locally (assignment or
                   import from somewhere other than the registry) — the
                   value can silently drift from the registry's
  PRNG-SITE        a registered salt key-created in a module outside its
                   declared site list (one salt, two meanings)
  PRNG-COLLISION   two registered salts share a numeric value
                   (from salts.check_registry)

Only XOR-salted roots are audited: unsalted roots (``PRNGKey(seed)``,
``default_rng(seed)``) are the engines' primary chains and are
documented at their definition sites; the registry exists to keep the
*derived* address spaces disjoint.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.base import Violation, module_name
from repro_torch.analysis.salts import REGISTRY

SALTS_MODULE = "repro_torch.analysis.salts"
#: callables whose first argument seeds a PRNG stream
KEY_CREATORS = ("PRNGKey", "default_rng", "RandomState", "seed", "key")
#: of those, bare-name calls we accept only for these names (the rest
#: must be attribute calls like np.random.default_rng to count)
BARE_CREATORS = ("PRNGKey", "default_rng")


def _attr_last(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_key_creation(call: ast.Call) -> bool:
    name = _attr_last(call.func)
    if name is None or not call.args:
        return False
    if isinstance(call.func, ast.Name):
        return name in BARE_CREATORS
    if name in ("PRNGKey", "default_rng", "RandomState"):
        return True
    # np.random.seed(x) / <module>.random.key(x)
    if name in ("seed", "key") and isinstance(call.func, ast.Attribute):
        owner = _attr_last(call.func.value)
        return owner == "random"
    return False


def _salt_like(name: str) -> bool:
    return name.isupper() and name.endswith("_SALT")


class _SaltImports(ast.NodeVisitor):
    """Where each registered-salt-looking name is bound in a module."""

    def __init__(self):
        self.origin: Dict[str, str] = {}   # name -> module it came from
        self.local: Dict[str, int] = {}    # name -> assignment line
        self.salts_aliases: List[str] = []  # names bound to the registry
                                            # module itself

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for a in node.names:
            bound = a.asname or a.name
            if node.module and a.name == "salts" \
                    and node.module + ".salts" == SALTS_MODULE:
                self.salts_aliases.append(bound)
            elif _salt_like(a.name):
                self.origin[bound] = node.module or ""

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.name == SALTS_MODULE:
                self.salts_aliases.append(a.asname or a.name)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Name) and _salt_like(t.id):
                self.local[t.id] = node.lineno
        self.generic_visit(node)


def _xor_operands(expr: ast.expr) -> List[ast.BinOp]:
    """All BitXor BinOps anywhere inside ``expr``."""
    return [n for n in ast.walk(expr)
            if isinstance(n, ast.BinOp) and isinstance(n.op, ast.BitXor)]


def check_file(path: str, source: Optional[str] = None) -> List[Violation]:
    src = source if source is not None else open(path).read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Violation("PRNG-PARSE", path, e.lineno or 0,
                          f"cannot parse: {e.msg}")]
    mod = module_name(path)
    imports = _SaltImports()
    imports.visit(tree)
    out: List[Violation] = []

    def audit_salt_operand(op: ast.expr, line: int) -> None:
        # Attribute access through a registry-module alias is fine
        if isinstance(op, ast.Attribute) and _salt_like(op.attr):
            owner = op.value
            if isinstance(owner, ast.Name) \
                    and owner.id in imports.salts_aliases:
                check_registered(op.attr, line)
            else:
                out.append(Violation(
                    "PRNG-LOCAL", path, line,
                    f"salt {op.attr} accessed through "
                    f"{ast.unparse(owner)}, not the registry module "
                    f"({SALTS_MODULE})"))
            return
        if isinstance(op, ast.Constant) and isinstance(op.value, int):
            out.append(Violation(
                "PRNG-UNDECLARED", path, line,
                f"raw salt literal {op.value:#x} in a PRNG key creation "
                f"— declare it in {SALTS_MODULE} and import it"))
            return
        if isinstance(op, ast.Name) and _salt_like(op.id):
            name = op.id
            if name in imports.local:
                out.append(Violation(
                    "PRNG-LOCAL", path, line,
                    f"salt {name} assigned locally (line "
                    f"{imports.local[name]}) instead of imported from "
                    f"{SALTS_MODULE}"))
                return
            origin = imports.origin.get(name)
            if origin is None and mod != SALTS_MODULE:
                out.append(Violation(
                    "PRNG-UNKNOWN", path, line,
                    f"salt name {name} is not imported in this module"))
                return
            if origin is not None and origin != SALTS_MODULE:
                out.append(Violation(
                    "PRNG-LOCAL", path, line,
                    f"salt {name} imported from {origin}, not from "
                    f"{SALTS_MODULE}"))
                return
            check_registered(name, line)

    def check_registered(name: str, line: int) -> None:
        salt = REGISTRY.get(name)
        if salt is None:
            out.append(Violation(
                "PRNG-UNKNOWN", path, line,
                f"salt name {name} is not declared in {SALTS_MODULE}"))
            return
        if mod not in salt.sites:
            out.append(Violation(
                "PRNG-SITE", path, line,
                f"salt {name} key-created in {mod}, which is not in its "
                f"declared sites {list(salt.sites)} — if this module "
                f"legitimately feeds the same chain, add it to the "
                f"registry entry; otherwise declare a new salt"))

    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_key_creation(node)):
            continue
        for xor in _xor_operands(node.args[0]):
            for op in (xor.left, xor.right):
                # the non-salt side is the seed variable; only constants
                # and *_SALT-style names are audited as salts
                if isinstance(op, ast.Constant) \
                        or (_attr_last(op) or "").endswith("_SALT"):
                    audit_salt_operand(op, node.lineno)
    return out


def check_files(paths: Sequence[str]) -> List[Violation]:
    out: List[Violation] = []
    for p in paths:
        out.extend(check_file(p))
    return out
