"""One call path for the port's hand-written kernels, and the kNN route
picked from the device.

``utils/cuda_build.py`` builds, binds, launches and counts every kernel;
the wrappers keep their checks, their plain versions and the device rule.
These tests scan the package's sources for the seam and run every
wrapper's plain route on the CPU: no launch is counted there. The launch
itself needs a card (``chip_smoke.py`` and the card tests run it); here
``launch`` is driven with a stand-in launcher to check how it counts and
how it fails.
"""

import ast
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from reconstructor_tpu_torch.ba import cuda_blocks, cuda_schur, cuda_segsum
from reconstructor_tpu_torch.geometry import cuda_fgate
from reconstructor_tpu_torch.matching import cuda_knn, cuda_sinkhorn, gated, knn
from reconstructor_tpu_torch.scripts import profile_knn_kernel
from reconstructor_tpu_torch.utils import cuda_build

PKG = Path(cuda_build.__file__).resolve().parents[1]
SOURCES = sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)
CALL_PATH = PKG / "utils" / "cuda_build.py"
# the host C++ runtime's bindings (native/*.cpp, no kernel and no stream)
HOST_LIBRARIES = {PKG / "io" / "native.py", PKG / "eval" / "ba_native.py"}


def _rel(p: Path) -> str:
    return str(p.relative_to(PKG))


def _assigned_attrs(tree) -> set:
    return {t.attr for n in ast.walk(tree) if isinstance(n, ast.Assign)
            for t in n.targets for t in (t.elts if isinstance(t, ast.Tuple) else [t])
            if isinstance(t, ast.Attribute)}


def _names(tree) -> set:
    return ({n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
            | {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
            | {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
               and isinstance(n.value, str)})


def _binds(tree) -> bool:
    return bool({"argtypes", "restype"} & _assigned_attrs(tree))


def _fetches_stream(tree) -> bool:
    return bool({"current_stream", "_cuda_getCurrentRawStream", "cuda_stream"} & _names(tree))


def _counts_launches(tree) -> bool:
    top = {t.id for n in tree.body if isinstance(n, (ast.Assign, ast.AnnAssign))
           for t in (n.targets if isinstance(n, ast.Assign) else [n.target])
           if isinstance(t, ast.Name)}
    defs = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    return any(name.startswith("LAUNCHES") for name in top) or "reset_launches" in defs


@pytest.mark.parametrize("rule,exempt", [(_binds, HOST_LIBRARIES), (_fetches_stream, set()),
                                         (_counts_launches, set())],
                         ids=["argtypes", "stream", "counter"])
def test_only_cuda_build_binds_launches_and_counts(rule, exempt):
    """(a) No module of the package but ``utils/cuda_build.py`` sets
    ``argtypes``/``restype``, fetches a CUDA stream or keeps a launch
    counter (``LAUNCHES``, ``reset_launches``)."""
    found = [_rel(p) for p in SOURCES
             if p != CALL_PATH and p not in exempt and rule(ast.parse(p.read_text()))]
    assert found == []
    assert rule(ast.parse(CALL_PATH.read_text()))


@pytest.mark.parametrize("layer", ["geometry", "matching"])
def test_geometry_and_matching_import_nothing_from_ba(layer):
    """(b) The geometry and matching layers do not reach into BA."""
    found = []
    for p in sorted((PKG / layer).rglob("*.py")):
        for n in ast.walk(ast.parse(p.read_text())):
            mods = ([a.name for a in n.names] if isinstance(n, ast.Import) else
                    [n.module or ""] + [f"{n.module}.{a.name}" for a in n.names]
                    if isinstance(n, ast.ImportFrom) else [])
            found += [(_rel(p), m) for m in mods
                      if m == "reconstructor_tpu_torch.ba"
                      or m.startswith("reconstructor_tpu_torch.ba.")]
    assert found == []


def _layout_case():
    g = torch.Generator().manual_seed(0)
    O, C, L = 200, 5, 40
    obs_cam = torch.randint(0, C, (O,), generator=g)
    obs_pt = torch.randint(0, L, (O,), generator=g)
    lay = cuda_schur.schur_layout(obs_cam, obs_pt, C, L)
    Y = torch.randn(O, 12, 3, generator=g)
    return g, O, C, L, lay, Y


def _knn_case(packed: bool, level=None):
    g = torch.Generator().manual_seed(1)
    desc = torch.nn.functional.normalize(torch.randn(3, 128, 128, generator=g), dim=-1)
    pairs = torch.tensor([[0, 1], [1, 2]], dtype=torch.int32)
    if level is not None:
        return lambda: profile_knn_kernel.run(desc, pairs, level)
    bias = torch.zeros(3, 128, dtype=torch.int32 if packed else torch.float32)
    return lambda: cuda_knn.knn_topk2(desc, bias, pairs, packed=packed)


def _plain_routes():
    g, O, C, L, lay, Y = _layout_case()
    f = torch.randn(2, 16, 9, generator=g)
    pts = torch.rand(2, 64, 2, generator=g) * 100
    m0 = torch.ones(2, 6, dtype=torch.bool)
    C1, mu, nu, _ = cuda_sinkhorn.augment(torch.randn(2, 6, 6, generator=g),
                                          torch.tensor(0.5), m0, m0)
    return {
        "seg_sum": lambda: cuda_segsum.seg_sum(torch.randn(O, 3, generator=g), lay.pt),
        "ytu_sum": lambda: cuda_schur.ytu_sum(Y, torch.randn(C, 12, generator=g), lay),
        "yz_sum": lambda: cuda_schur.yz_sum(Y, torch.randn(L, 3, generator=g), lay),
        "block3_matvec": lambda: cuda_blocks.block3_matvec(torch.randn(9, L, generator=g),
                                                           torch.randn(L, 3, generator=g)),
        "sampson_counts": lambda: cuda_fgate.sampson_counts(
            f, pts, pts + 1, torch.ones(2, 64, dtype=torch.bool), 2, 9.0),
        "knn_topk2": _knn_case(packed=False),
        "knn_topk2_packed": _knn_case(packed=True),
        "knn_levels": _knn_case(packed=False, level=2),
        "sinkhorn": lambda: cuda_sinkhorn.sinkhorn_kernel(C1, mu, nu, 5),
    }


@pytest.mark.parametrize("route", sorted(_plain_routes()))
def test_plain_routes_count_no_launch(route):
    """(c) The counters read zero after ``reset_launches()`` and stay zero
    across a CPU call of each wrapper's plain route."""
    fn = _plain_routes()[route]
    cuda_build.reset_launches()
    assert cuda_build.launches() == {}
    fn()
    assert cuda_build.launches() == {}
    assert cuda_build.launches()["seg_sum_launch"] == 0     # an unlaunched name reads 0


def test_launch_counts_under_its_name_or_key_and_raises_the_kernels_message(monkeypatch):
    """``launch`` on a stand-in library: the current stream is passed last,
    a success counts under the launcher's name (or the given key), a
    non-zero status raises with the library's message and counts nothing."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(cuda_build, "_stream", lambda index: 1234)
    calls = []

    def launcher(*args):
        calls.append(args)
        return args[0]
    bound = {"k_launch": launcher, "error": lambda status: b"bad shape"}
    dev = torch.device("cuda", 0)
    cuda_build.reset_launches()
    cuda_build.launch(bound, "k_launch", (0, 7), dev)
    cuda_build.launch(bound, "k_launch", (0, 8), dev, key="k_launch_bf16")
    with pytest.raises(RuntimeError, match="k_launch failed: bad shape"):
        cuda_build.launch(bound, "k_launch", (3, 9), dev)
    assert calls == [(0, 7, 1234), (0, 8, 1234), (3, 9, 1234)]
    assert cuda_build.launches() == {"k_launch": 1, "k_launch_bf16": 1}
    cuda_build.reset_launches()
    assert cuda_build.launches() == {}


def test_no_port_function_takes_use_fused():
    """(d) The kNN route is the descriptors' device, not a parameter."""
    found = [(_rel(p), n.name) for p in SOURCES for n in ast.walk(ast.parse(p.read_text()))
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
             and "use_fused" in {a.arg for a in n.args.args + n.args.kwonlyargs}]
    assert found == []


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_knn_route_follows_the_device(monkeypatch, device):
    """``gated.match_pairs``, which the gate and the sharded matchers call,
    takes the kernel's matcher for descriptors on a card and the plain
    matcher elsewhere, looking each up on its module at call time (where
    the benchmark wraps it)."""
    taken = []

    def stand_in(name):
        def fn(desc, kmask, pair_chunk, **kw):
            taken.append((name, kw))
            return name
        return fn
    monkeypatch.setattr(cuda_knn, "match_all_pairs_fused", stand_in("fused"))
    monkeypatch.setattr(knn, "match_all_pairs", stand_in("plain"))
    desc = types.SimpleNamespace(device=torch.device(device))
    got = gated.match_pairs(desc, None, None, 0.8, False, "bfloat16")
    want = "fused" if device == "cuda" else "plain"
    assert got == want
    assert taken == [(want, dict(ratio_thresh=0.8, cross_check=False,
                                 compute_dtype="bfloat16"))]


def test_cpu_gate_takes_the_plain_matcher():
    """On CPU tensors the gate's kNN is ``knn.match_all_pairs`` itself: the
    same tables as calling it directly."""
    rng = np.random.default_rng(4)
    desc = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((3, 128, 128)).astype(np.float32)), dim=-1)
    mask = torch.ones(3, 128, dtype=torch.bool)
    pairs = torch.tensor([[0, 1], [0, 2]], dtype=torch.int32)
    for a, b in zip(gated.match_pairs(desc, mask, pairs, 0.9, True),
                    knn.match_all_pairs(desc, mask, pairs, ratio_thresh=0.9, cross_check=True)):
        assert torch.equal(a, b)
