"""ctypes binding for the native C++ DENSE_SCHUR LM baseline.

``native/ba_schur.cpp`` is the Ceres stand-in this framework's TPU BA is
benchmarked against: same residual (BundleAdjuster.h:26-58), Jet-based
forward autodiff (Ceres's AutoDiffCostFunction mechanism), Schur
elimination with a dense reduced camera system (DENSE_SCHUR,
BundleAdjuster.cpp:132), OpenMP with the reference's 4 threads
(SequentialReconstructor.h:17), float64 like Ceres.

A copy of ``reconstructor_tpu.eval.ba_native`` that loads the library
through this package's ``io.native``. Where the library does not load (no
``native/libreconstructor_native.so`` and no compiler to build it), the
call raises.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

from reconstructor_tpu_torch.io.native import _SO_PATH, _load as _load_lib


def solve_native_ba(cam_params: np.ndarray, points: np.ndarray,
                    obs_cam: np.ndarray, obs_pt: np.ndarray,
                    obs_uv: np.ndarray, cam_free: np.ndarray,
                    max_iters: int = 50, lambda_init: float = 1e-3,
                    lambda_up: float = 4.0, lambda_down: float = 2.0,
                    ftol: float = 1e-8, num_threads: int = 4) -> dict:
    """Run the native LM on a dense-packed problem; returns stats + the
    refined parameters. Observations may arrive in any order; they are
    sorted landmark-major here (the solver wants per-point runs)."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"the native library {_SO_PATH} did not load or build")
    lib.ba_schur_solve.restype = ctypes.c_int
    lib.ba_schur_solve.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]

    C = cam_params.shape[0]
    L = points.shape[0]
    order = np.argsort(obs_pt, kind="stable")
    oc = np.ascontiguousarray(obs_cam[order], np.int32)
    op = np.ascontiguousarray(obs_pt[order], np.int32)
    ouv = np.ascontiguousarray(obs_uv[order], np.float64)
    counts = np.bincount(op, minlength=L)
    offsets = np.zeros(L + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])

    cams = np.ascontiguousarray(cam_params, np.float64).copy()
    pts = np.ascontiguousarray(points, np.float64).copy()
    free = np.ascontiguousarray(cam_free, np.float64)
    final_cost = ctypes.c_double(0.0)
    trace_cost = np.zeros(max_iters, np.float64)
    trace_time = np.zeros(max_iters, np.float64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    t0 = time.time()
    iters = lib.ba_schur_solve(
        p(cams, ctypes.c_double), p(pts, ctypes.c_double),
        C, L, p(oc, ctypes.c_int32), p(op, ctypes.c_int32),
        p(ouv, ctypes.c_double), oc.size, p(offsets, ctypes.c_int64),
        p(free, ctypes.c_double), max_iters, lambda_init, lambda_up,
        lambda_down, ftol, num_threads, ctypes.byref(final_cost),
        p(trace_cost, ctypes.c_double), p(trace_time, ctypes.c_double))
    dt = time.time() - t0
    iters = max(int(iters), 1)
    return {
        "total_s": dt,
        "iters": iters,
        "s_per_iter": dt / iters,
        "cost_final": float(final_cost.value),
        "cost_trace": trace_cost,
        "time_trace": trace_time,
        "cam_params": cams,
        "points": pts,
    }
