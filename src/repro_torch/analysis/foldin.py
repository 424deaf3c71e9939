"""fold_in address-chain auditor (rule family PRNG-FOLDIN-*).

Every salt-rooted key (``prng.PRNGKey(seed ^ X_SALT)``) heads an address
chain: each ``prng.fold_in(key, addr)`` appends one coordinate to the
chain's address tuple.  The port's ``fold_in`` is batched (a ``[..., 2]``
key against an integer tensor), so the reference's
``vmap(fold_in)(keys, addrs)`` is spelled ``prng.fold_in(key[None, :],
addrs)`` here: an index or a ``.to(device)`` of a key carries its
chain unchanged.  Two *different*
derivations folded into the same chain position can alias a key
stream; this pass audits the argument tuples per chain:

  PRNG-FOLDIN-DUP    the same constant folded into one chain at two
                     distinct sites — both derivations alias a single
                     sub-stream
  PRNG-FOLDIN-MIXED  a chain with constant sub-stream branches that is
                     also folded by a runtime variable — the variable
                     can hit a branch constant and collide with it
  PRNG-FOLDIN-VAR    two different variable expressions folded into the
                     same chain — addresses drawn from unrelated
                     domains can coincide

Identical variable expressions folded at several sites are ALLOWED:
the engines derive the same address on purpose (parity twins), e.g.
``fold_in(self._bc_base, k)`` in both the tick and the seconds draw of
a broadcast — so twins must spell the address identically.

Chains are tracked per top-level scope (module body, each top-level
function, each class with all its methods): the same salt may
legitimately root chains with different address layouts in different
classes — e.g. AVAIL_SALT is folded by the epoch in one churn model and
by another epoch index in another — and only same-scope reuse shares a
stream.  Like the PRNG-* audit, only XOR-salted roots are in scope;
unsalted roots are the engines' primary chains and are documented at
their definition sites.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.base import Violation
from repro_torch.analysis.prng import (_attr_last, _is_key_creation,
                                       _salt_like, _xor_operands)

#: a chain identity: (salt name, *address coordinates folded so far)
Chain = Tuple[str, ...]
#: one fold site: (kind "const"|"var", address repr, line)
Site = Tuple[str, str, int]


def _salt_of(call: ast.Call) -> Optional[str]:
    """Salt name if ``call`` is a salt-rooted key creation, else None."""
    if not _is_key_creation(call):
        return None
    for xor in _xor_operands(call.args[0]):
        for op in (xor.left, xor.right):
            name = _attr_last(op)
            if name is not None and _salt_like(name):
                return name
    return None


def _fold_args(call: ast.Call) -> Optional[Tuple[ast.expr, ast.expr]]:
    """(key expr, addr expr) if ``call`` applies fold_in, else None."""
    if _attr_last(call.func) == "fold_in" and len(call.args) >= 2:
        return call.args[0], call.args[1]
    return None


def _key_operand(expr: ast.expr) -> ast.expr:
    """Strip indexing and device moves off a key expression: ``base[None,
    :]`` and ``base.to(dev)`` carry ``base``'s chain."""
    while True:
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        elif isinstance(expr, ast.Call) \
                and isinstance(expr.func, ast.Attribute) \
                and expr.func.attr == "to":
            expr = expr.func.value
        else:
            return expr


def _addr_site(addr: ast.expr, line: int) -> Site:
    if isinstance(addr, ast.Constant):
        return ("const", repr(addr.value), line)
    return ("var", ast.unparse(addr), line)


def _chain_of(expr: ast.expr,
              tracked: Dict[str, Chain]) -> Optional[Chain]:
    """Resolve an expression to the chain it carries, or None.

    Names and attributes resolve through ``tracked``; inline
    ``PRNGKey(seed ^ SALT)`` and inline (possibly nested) fold_in
    calls resolve structurally; views of a key (``_key_operand``) carry
    its chain.
    """
    expr = _key_operand(expr)
    if isinstance(expr, (ast.Name, ast.Attribute)):
        return tracked.get(ast.unparse(expr))
    if isinstance(expr, ast.Call):
        salt = _salt_of(expr)
        if salt is not None:
            return (salt,)
        fold = _fold_args(expr)
        if fold is not None:
            parent = _chain_of(fold[0], tracked)
            if parent is not None:
                kind, rep, _ = _addr_site(fold[1], expr.lineno)
                return parent + (rep,)
    return None


def _scopes(tree: ast.Module) -> List[List[ast.stmt]]:
    """Top-level scope units: each def/class subtree, plus the rest of
    the module body as one unit.  Nested closures stay with their
    enclosing top-level unit, so a key bound in a factory and folded
    inside the closure it returns resolves within one scope."""
    units: List[List[ast.stmt]] = []
    rest: List[ast.stmt] = []
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            units.append([stmt])
        else:
            rest.append(stmt)
    if rest:
        units.append(rest)
    return units


def _scope_sites(stmts: Sequence[ast.stmt]) -> Dict[Chain, Set[Site]]:
    nodes = [n for s in stmts for n in ast.walk(s)]
    # bind chains to names/attributes, to fixpoint: a derived key's
    # chain may be defined by an assignment seen before its parent's
    tracked: Dict[str, Chain] = {}
    assigns = [n for n in nodes if isinstance(n, ast.Assign)
               and len(n.targets) == 1
               and isinstance(n.targets[0], (ast.Name, ast.Attribute))]
    changed = True
    while changed:
        changed = False
        for a in assigns:
            target = ast.unparse(a.targets[0])
            if target in tracked:
                continue
            chain = _chain_of(a.value, tracked)
            if chain is not None:
                tracked[target] = chain
                changed = True
    sites: Dict[Chain, Set[Site]] = {}
    for n in nodes:
        if not isinstance(n, ast.Call):
            continue
        fold = _fold_args(n)
        if fold is None:
            continue
        chain = _chain_of(fold[0], tracked)
        if chain is None:
            continue
        sites.setdefault(chain, set()).add(_addr_site(fold[1], n.lineno))
    return sites


def _audit_chain(path: str, chain: Chain,
                 sites: Set[Site]) -> List[Violation]:
    out: List[Violation] = []
    label = " -> ".join(chain)
    consts: Dict[str, List[int]] = {}
    var_reps: Dict[str, List[int]] = {}
    for kind, rep, line in sites:
        (consts if kind == "const" else var_reps).setdefault(
            rep, []).append(line)
    for rep, lines in sorted(consts.items()):
        if len(set(lines)) > 1:
            lo, hi = min(lines), max(lines)
            out.append(Violation(
                "PRNG-FOLDIN-DUP", path, hi,
                f"constant {rep} folded into chain [{label}] at lines "
                f"{lo} and {hi} — both derivations alias one key "
                f"stream; give each branch its own constant"))
    if consts and var_reps:
        rep, lines = sorted(var_reps.items())[0]
        out.append(Violation(
            "PRNG-FOLDIN-MIXED", path, min(lines),
            f"chain [{label}] has constant sub-stream branch(es) "
            f"{sorted(consts)} but is also folded by variable {rep} — "
            f"a runtime address equal to a branch constant collides; "
            f"fold the variable on a dedicated constant branch"))
    if len(var_reps) > 1:
        (rep_a, lines_a), (rep_b, lines_b) = sorted(var_reps.items())[:2]
        out.append(Violation(
            "PRNG-FOLDIN-VAR", path, max(min(lines_a), min(lines_b)),
            f"chain [{label}] folded by two different variable "
            f"expressions, {rep_a} (line {min(lines_a)}) and {rep_b} "
            f"(line {min(lines_b)}) — addresses from unrelated domains "
            f"can coincide; branch the chain by constants first"))
    return out


def check_file(path: str, source: Optional[str] = None) -> List[Violation]:
    src = source if source is not None else open(path).read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError:
        return []   # prng.check_file already reports PRNG-PARSE
    out: List[Violation] = []
    for stmts in _scopes(tree):
        for chain, sites in sorted(_scope_sites(stmts).items()):
            out.extend(_audit_chain(path, chain, sites))
    return out


def check_files(paths: Sequence[str]) -> List[Violation]:
    out: List[Violation] = []
    for p in paths:
        out.extend(check_file(p))
    return out
