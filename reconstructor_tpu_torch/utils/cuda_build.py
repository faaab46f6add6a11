"""Build-at-first-use for the package's hand-written CUDA kernels.

Each kernel source under ``<package>/**/csrc/*.cu`` exposes a plain
``extern "C"`` launcher. It is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes. Libraries are
named by a hash of their source, its headers and the flags, so an edited
source never loads a stale build, and are written atomically, so
builders that run at once (threads or processes) need no lock and never
see a half-written file: ``load`` of two sources from two threads runs
their ``nvcc`` builds side by side.

The build directory is ``build/kernels`` beside the package (listed in
``.gitignore``), or ``$RECONSTRUCTOR_TORCH_BUILD_DIR`` when set. Nothing
is compiled or loaded at import time: the first call of a kernel's
wrapper on a CUDA tensor builds it. ``-Xptxas -v`` makes nvcc print each
kernel's registers, shared memory and spills; ``build_log`` returns it.

A source may ``#include "..."`` a header by a path relative to its own
directory, as nvcc resolves it (the kNN kernels share
``matching/csrc/knn_wgmma.cuh``): the hash covers the source and every
file it reaches that way (``sources``), so an edit to a header rebuilds
every kernel that includes it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_PKG = Path(__file__).resolve().parents[1]
_LIBS: Dict[str, ctypes.CDLL] = {}
_QUOTED_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def build_dir() -> Path:
    d = os.environ.get("RECONSTRUCTOR_TORCH_BUILD_DIR")
    return Path(d) if d else _PKG.parent / "build" / "kernels"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def sources(src: Path) -> List[Path]:
    """``src`` and every file it reaches through quoted ``#include``s,
    each resolved from the directory of the file that includes it (as
    nvcc does) and listed once, in the order first reached. Quoted names
    that are not files there (nvcc would search its include path) are
    left out."""
    found: List[Path] = []
    todo = [Path(src).resolve()]
    while todo:
        f = todo.pop(0)
        if f in found:
            continue
        found.append(f)
        for name in _QUOTED_INCLUDE.findall(f.read_text()):
            inc = (f.parent / name).resolve()
            if inc.is_file():
                todo.append(inc)
    return found


def library_path(src: Path) -> Path:
    """Where the library of ``src`` is built: named by a hash of the
    source, the files it includes (``sources``) and the flags."""
    h = hashlib.sha256()
    for f in sources(src):
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return build_dir() / f"lib{Path(src).stem}_{h.hexdigest()[:12]}.so"


def _build(src: Path) -> Path:
    out = library_path(src)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(out.parent))
    os.close(fd)
    proc = subprocess.run([nvcc_path()] + FLAGS + ["-o", tmp, str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src.name}:\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)
    return out


def build_log(rel: str) -> str:
    """What nvcc printed when it built a kernel source (``-Xptxas -v``:
    registers, shared memory, spills of each kernel), after ``load``."""
    return _build(_PKG / rel).with_suffix(".log").read_text()


def load(rel: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of one kernel source, given
    relative to the package."""
    lib = _LIBS.get(rel)
    if lib is None:
        lib = _LIBS.setdefault(rel, ctypes.CDLL(str(_build(_PKG / rel))))
    return lib
