"""The port's cache of compiled kernels (``utils/cuda_build.py``), the
counterpart of the JAX package's executable cache (``utils/aot.py``,
``tests/test_aot_cache.py``): libraries named by a hash of what was
compiled, written atomically, shared across processes through the build
directory. The port runs eagerly, so it has no XLA executable to keep;
``nvcc``'s output is its only compiled code.

The tests need no ``nvcc``: ``nvcc_path`` is pointed at stand-ins, a
script that writes a copy of a shared library that exists on every
Python (``_ctypes``'s) where nvcc would write its output, or a command
that fails.
"""

import ctypes
import os
import stat
import threading
from pathlib import Path

import _ctypes
import pytest

from reconstructor_tpu_torch.utils import cuda_build

SOURCE = 'extern "C" int answer() { return 42; }\n'


@pytest.fixture
def pkg(tmp_path, monkeypatch):
    """A package directory holding one kernel source, and an empty build
    directory; the module's loaded-library table emptied."""
    root = tmp_path / "pkg"
    (root / "csrc").mkdir(parents=True)
    (root / "csrc" / "k.cu").write_text(SOURCE)
    monkeypatch.setattr(cuda_build, "_PKG", root)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setenv("RECONSTRUCTOR_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return root


def fake_nvcc(tmp_path, monkeypatch, calls_file):
    """An nvcc that records its call, prints a ptxas-like line and writes
    a loadable library at its ``-o`` argument."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{calls_file}"\n'
        'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then out="$2"; fi; shift; done\n'
        "sleep 0.2\n"
        f'cp "{_ctypes.__file__}" "$out"\n'
        'echo "ptxas info    : Used 32 registers"\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(script))


def failing_nvcc(monkeypatch):
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "false")


def test_a_built_library_loads_without_running_nvcc(pkg, monkeypatch):
    failing_nvcc(monkeypatch)
    lib = cuda_build.library_path(pkg / "csrc" / "k.cu")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(Path(_ctypes.__file__).read_bytes())
    lib.with_suffix(".log").write_text("ptxas info: cached\n")
    assert isinstance(cuda_build.load("csrc/k.cu"), ctypes.CDLL)
    assert cuda_build.build_log("csrc/k.cu") == "ptxas info: cached\n"
    assert cuda_build.load("csrc/k.cu") is cuda_build.load("csrc/k.cu")
    # without the library, the failing nvcc runs, raises and leaves no file
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    lib.unlink()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build.load("csrc/k.cu")
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.with_suffix(".log").name]


def test_flags_or_source_change_the_name(pkg, monkeypatch):
    src = pkg / "csrc" / "k.cu"
    first = cuda_build.library_path(src)
    assert first.parent == cuda_build.build_dir() and first.name.startswith("libk_")
    assert cuda_build.library_path(src) == first
    with monkeypatch.context() as m:
        m.setattr(cuda_build, "FLAGS", cuda_build.FLAGS + ["-lineinfo"])
        flagged = cuda_build.library_path(src)
    assert flagged != first
    assert cuda_build.library_path(src) == first
    src.write_text(SOURCE.replace("42", "43"))
    assert cuda_build.library_path(src) not in (first, flagged)
    src.write_text(SOURCE)
    assert cuda_build.library_path(src) == first


def test_a_corrupt_cached_library_raises(pkg, monkeypatch):
    """A damaged file at the library's path makes ``load`` raise (the
    loader's error); it is neither rebuilt over nor replaced by a plain
    fallback, and nvcc does not run."""
    failing_nvcc(monkeypatch)
    lib = cuda_build.library_path(pkg / "csrc" / "k.cu")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"\x7fELF" + b"\0" * 60)
    with pytest.raises(OSError):
        cuda_build.load("csrc/k.cu")
    assert lib.read_bytes() == b"\x7fELF" + b"\0" * 60


def test_concurrent_builds_write_one_library_atomically(pkg, tmp_path, monkeypatch):
    """Two threads load the same unbuilt source at once: nvcc's output goes
    to a temporary file that is renamed into place, so both load a whole
    library, no temporary file is left, and the log is nvcc's output. A
    third load (a fresh process's table) finds it and runs nothing."""
    calls = tmp_path / "calls.txt"
    fake_nvcc(tmp_path, monkeypatch, calls)
    got = []
    src = pkg / "csrc" / "k.cu"
    threads = [threading.Thread(target=lambda: got.append(cuda_build._build(src)))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lib = cuda_build.library_path(pkg / "csrc" / "k.cu")
    assert got == [lib, lib]
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted([lib.name,
                                                                   lib.with_suffix(".log").name])
    assert lib.read_bytes() == Path(_ctypes.__file__).read_bytes()
    assert "Used 32 registers" in cuda_build.build_log("csrc/k.cu")
    n_calls = len(calls.read_text().splitlines())
    assert 1 <= n_calls <= 2
    assert all(line.split()[:len(cuda_build.FLAGS)] == cuda_build.FLAGS
               for line in calls.read_text().splitlines())
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    assert isinstance(cuda_build.load("csrc/k.cu"), ctypes.CDLL)
    assert len(calls.read_text().splitlines()) == n_calls
    assert os.environ["RECONSTRUCTOR_TORCH_BUILD_DIR"] == str(lib.parent)
