"""Isolation: no module that the benchmark runs imports JAX or the JAX
package, and the plain reference imports nothing of the program either.

Every import statement of a module (at any depth, in functions too) is read
from its source; its top-level name, the part before the first dot, is
compared whole, so ``reconstructor_tpu_torch`` is not ``reconstructor_tpu``.
The walk follows imports of ``benchmark`` and of the program into their
files, so it covers every module of either that a run can load.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, Set

from benchmark.tests.tiny import REPO

JAX = {"jax", "jaxlib", "flax", "reconstructor_tpu"}
PROGRAM = "reconstructor_tpu_torch"


def _imports(path: Path) -> Set[str]:
    """Full dotted names imported by ``path`` (relative imports resolved)."""
    tree = ast.parse(path.read_text())
    pkg = ".".join(path.relative_to(REPO).with_suffix("").parts[:-1])
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            out.add(base)
            out.update(f"{base}.{a.name}" for a in node.names)
    return out


def _file(name: str):
    """The source file of an importable dotted name inside the repository."""
    p = REPO.joinpath(*name.split("."))
    for cand in (p.with_suffix(".py"), p / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def _walk(start: Iterable[Path], follow: Set[str]) -> Dict[Path, Set[str]]:
    """Modules reachable from ``start`` through imports whose top-level name
    is in ``follow``, each with the names it imports."""
    seen: Dict[Path, Set[str]] = {}
    todo = list(start)
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen[path] = _imports(path)
        for name in seen[path]:
            if name.split(".")[0] in follow:
                f = _file(name)
                if f is not None and f not in seen:
                    todo.append(f)
    return seen


def _bench_sources():
    return [p for p in (REPO / "benchmark").rglob("*.py")
            if "tests" not in p.parts and "__pycache__" not in p.parts]


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    walked = _walk(_bench_sources(), {"benchmark", PROGRAM})
    assert any(PROGRAM in str(p) for p in walked), "the walk never reached the program"
    bad = {str(p.relative_to(REPO)): sorted(n for n in names if n.split(".")[0] in JAX)
           for p, names in walked.items()}
    assert not {k: v for k, v in bad.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    start = list((REPO / "benchmark" / "reference").glob("*.py"))
    walked = _walk(start, {"benchmark"})
    for path, names in walked.items():
        assert path.parent == REPO / "benchmark" / "reference", path
        tops = {n.split(".")[0] for n in names}
        assert not tops & (JAX | {PROGRAM}), (path, tops)


def test_the_comparison_is_by_whole_top_level_name():
    assert "reconstructor_tpu_torch.matching".split(".")[0] not in JAX
    assert "reconstructor_tpu.matching".split(".")[0] in JAX
