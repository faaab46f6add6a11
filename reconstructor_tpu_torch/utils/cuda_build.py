"""Build-at-first-use for the package's hand-written CUDA kernels.

Each kernel source under ``<package>/**/csrc/*.cu`` exposes a plain
``extern "C"`` launcher. It is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes. Libraries are
named by a hash of their source and flags, so an edited source never
loads a stale build, and are written atomically, so builders that run at
once (threads or processes) need no lock and never see a half-written
file: ``load`` of two sources from two threads runs their ``nvcc``
builds side by side.

The build directory is ``build/kernels`` beside the package (listed in
``.gitignore``), or ``$RECONSTRUCTOR_TORCH_BUILD_DIR`` when set. Nothing
is compiled or loaded at import time: the first call of a kernel's
wrapper on a CUDA tensor builds it. ``-Xptxas -v`` makes nvcc print each
kernel's registers, shared memory and spills; ``build_log`` returns it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_PKG = Path(__file__).resolve().parents[1]
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    d = os.environ.get("RECONSTRUCTOR_TORCH_BUILD_DIR")
    return Path(d) if d else _PKG.parent / "build" / "kernels"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def _build(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    out = build_dir() / f"lib{src.stem}_{h}.so"
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
