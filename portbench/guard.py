"""The import guard: nothing the benchmark runs may load the JAX package
or JAX. Module names are compared by their top-level name (the part before
the first dot), whole: ``speech_tranformer_pytorch_tpu_torch`` is the port
under test and not the JAX package, whose name it begins with."""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List, Set

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "speech_tranformer_pytorch_tpu"})
PORT = "speech_tranformer_pytorch_tpu_torch"
HERE = os.path.dirname(os.path.abspath(__file__))


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def imported_names(path: str) -> Set[str]:
    """Top-level names of the absolute imports of one source file."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top_level(node.module))
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                out.add(top_level(node.args[0].value))
    return out


def sources(root: str = HERE) -> Iterable[str]:
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def scan(root: str = HERE) -> List[str]:
    """Violations in the benchmark's sources: a forbidden import anywhere,
    or the port imported by the reference."""
    bad = []
    ref = os.path.join(root, "reference")
    for path in sources(root):
        names = imported_names(path)
        for n in sorted(names & FORBIDDEN):
            bad.append(f"{os.path.relpath(path, root)} imports {n}")
        if path.startswith(ref + os.sep) and PORT in names:
            bad.append(f"{os.path.relpath(path, root)} (the reference) imports {PORT}")
    return bad


def loaded(modules: Iterable[str] = None) -> List[str]:
    """Forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & FORBIDDEN)
