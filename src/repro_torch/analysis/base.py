"""Shared plumbing for the port's static-analysis pass: the Violation
record every rule family emits, file collection, and module-path
derivation for site checks.

A ``Violation`` identifies one finding.  Its ``key()`` deliberately
excludes the line number so a baseline file survives unrelated edits
above a suppressed finding; the pass runs with an EMPTY baseline — the
key machinery exists for local triage while fixing a newly-introduced
rule, never as a permanent suppression channel.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, List, Sequence

#: the package whose modules the site lists name
PACKAGE = "repro_torch"


@dataclass(frozen=True)
class Violation:
    rule: str          # e.g. "PRNG-UNDECLARED"
    path: str          # file as given to the pass (or "<registry>")
    line: int          # 1-based; 0 when not tied to a source line
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def key(self) -> str:
        return f"{self.rule}|{os.path.basename(self.path)}|{self.message}"


def iter_py_files(paths: Sequence[str]) -> List[str]:
    """Expand files/directories into a sorted list of .py files."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                out.extend(os.path.join(root, n) for n in names
                           if n.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
        else:
            raise FileNotFoundError(f"not a .py file or directory: {p}")
    return sorted(set(out))


def module_name(path: str) -> str:
    """Dotted module path for site checks: the part of ``path`` from the
    last ``repro_torch`` component on (``.../src/repro_torch/cohort/
    engine.py`` -> ``repro_torch.cohort.engine``); bare stem for paths
    outside the package."""
    parts = os.path.normpath(path).split(os.sep)
    name = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
    if PACKAGE in parts[:-1]:
        i = len(parts) - 1 - parts[:-1][::-1].index(PACKAGE) - 1
        pkg = parts[i:-1]
        return ".".join(pkg + ([] if name == "__init__" else [name]))
    return name


def load_baseline(path: str) -> List[str]:
    """Baseline file: one ``Violation.key()`` per non-comment line."""
    keys: List[str] = []
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if ln and not ln.startswith("#"):
                keys.append(ln)
    return keys


def apply_baseline(violations: Iterable[Violation],
                   baseline_keys: Sequence[str]) -> List[Violation]:
    allowed = set(baseline_keys)
    return [v for v in violations if v.key() not in allowed]
