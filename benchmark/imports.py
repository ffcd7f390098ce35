"""The import check: no JAX in a benchmark process, and no program in the
reference.

Names are compared by their top-level part (before the first dot) whole:
the port's package name begins with the JAX package's.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mocca_envs_tpu"})
PROGRAM = "mocca_envs_tpu_torch"
REFERENCE = Path(__file__).resolve().parent / "reference"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top(n) in FORBIDDEN)


def imported_names(path: Path) -> set:
    """Every module name ``path`` imports, at any depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def reference_violations(root: Path = REFERENCE) -> list:
    """``(file, module)`` for each import under ``benchmark/reference/`` of
    the program or of a forbidden package."""
    bad = FORBIDDEN | {PROGRAM}
    return sorted((p.name, n) for p in root.glob("*.py") for n in imported_names(p)
                  if top(n) in bad)
