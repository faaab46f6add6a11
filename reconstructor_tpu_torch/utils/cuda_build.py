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

Every launcher returns an int status and the library exports a function
that maps a status to its message. ``bind`` declares the functions of a
library once; ``launch`` calls a launcher on the current raw stream of
the tensors' card, raises with the kernel's own message on a non-zero
status and counts the launch under the launcher's name (or the key a
wrapper gives), which ``launches`` reads and ``reset_launches`` zeroes.
A wrapper keeps its argument checks, its plain version and the rule of
which device takes which; a plain-version call counts nothing.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Any, Counter, Dict, List, Optional

import torch

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_PKG = Path(__file__).resolve().parents[1]
_LIBS: Dict[str, ctypes.CDLL] = {}
_BOUND: Dict[str, Dict[str, Any]] = {}
_LAUNCHES: Counter[str] = collections.Counter()
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


def bind(rel: str, fns: Dict[str, list], error_fn: str) -> Dict[str, Any]:
    """Build (if needed) and load the library of ``rel``; the first call
    declares each function's argtypes (``fns``: name -> argtypes, every one
    returning an int status) and ``error_fn``, which maps a status to its
    message, so a library's every function is named in its first call.
    Returns the bound functions by name, the message function under
    ``"error"``."""
    bound = _BOUND.get(rel)
    if bound is None:
        lib = load(rel)
        bound = {}
        for name, argtypes in fns.items():
            f = getattr(lib, name)
            f.argtypes, f.restype = argtypes, ctypes.c_int
            bound[name] = f
        err = getattr(lib, error_fn)
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        bound["error"] = err
        bound = _BOUND.setdefault(rel, bound)
    return bound


def check(bound: Dict[str, Any], status: int, what: str) -> None:
    """Raise ``RuntimeError`` with the library's message for a non-zero
    status of one of its functions."""
    if status != 0:
        raise RuntimeError(f"{what}: " + bound["error"](status).decode())


# the current stream's handle without building a torch.cuda.Stream object,
# which costs microseconds of host time on every call
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(bound: Dict[str, Any], name: str, args: tuple, dev: torch.device,
           key: Optional[str] = None) -> None:
    """Call launcher ``name`` of a ``bind`` result with ``args`` and the
    current stream of CUDA device ``dev`` (made current for the call if it
    is not); raise with the kernel's message when the launch fails, and
    count it under ``key`` (default: ``name``)."""
    fn = bound[name]
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    if index == current:
        status = fn(*args, _stream(index))
    else:
        with torch.cuda.device(index):
            status = fn(*args, _stream(index))
    check(bound, status, f"{name} failed")
    _LAUNCHES[key or name] += 1


def launches() -> Counter[str]:
    """Kernel launches since the last ``reset_launches``, by launcher
    name (or the key ``launch`` was given); a name not launched reads 0."""
    return collections.Counter(_LAUNCHES)


def reset_launches() -> None:
    _LAUNCHES.clear()
