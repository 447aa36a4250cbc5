"""ctypes bindings for the native C++ WALNUTS engine.

Compiles ``native/walnuts_engine.cpp`` on first use (cached next to
the source) and exposes:

* :func:`run` — single-chain WALNUTS-R2P / multinomial-NUTS draws;
* :func:`leapfrog_bench` — raw single-core leapfrog throughput.

The native engine serves as (a) the honest single-core baseline for
``bench.py``'s ``vs_baseline`` extras, and (b) a fast CPU oracle for
statistical cross-checks of the JAX engines (the role the external
``walnuts_cpp`` repo plays for the reference).
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "..", "native", "walnuts_engine.cpp")
_LIB = os.path.join(_HERE, "..", "..", "native", "libwalnuts_native.so")

TARGET_IDS = {"std_gauss": 0, "funnel": 1, "corr_gauss": 2}

_lock = threading.Lock()
_lib = None


def _build():
    subprocess.run(
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
         "-o", _LIB, _SRC],
        check=True, capture_output=True)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB)
        lib.walnuts_native_run.restype = ctypes.c_longlong
        lib.walnuts_native_run.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.walnuts_native_leapfrog_bench.restype = ctypes.c_longlong
        lib.walnuts_native_leapfrog_bench.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_double, ctypes.c_uint64,
        ]
        _lib = lib
        return lib


def run(target: str, dim: int, q0, n_iter: int, *, h0=0.3, delta=0.3,
        m=10, min_c=0, max_c=10, adaptive=True, seed=0,
        want_diag=False):
    """Run the native sampler; returns ``(draws [n_iter, dim],
    n_grad_evals)``, plus a ``[n_iter, 6]`` per-iteration diagnostics
    array ``{min If, max If, orbit min q[0], orbit max q[0], orbit
    energy error, grad evals}`` when ``want_diag`` is set."""
    lib = _load()
    q0 = np.ascontiguousarray(q0, np.float64)
    out = np.empty((n_iter, dim), np.float64)
    diag = np.empty((n_iter, 6), np.float64)
    n_grad = lib.walnuts_native_run(
        TARGET_IDS[target], dim, q0, n_iter, h0, delta, m, min_c, max_c,
        1 if adaptive else 0, seed, out, diag)
    if want_diag:
        return out, int(n_grad), diag
    return out, int(n_grad)


def leapfrog_bench(target: str, dim: int, n_steps: int, *, h=0.01, seed=0):
    """Run ``n_steps`` raw leapfrog micro steps; returns steps done."""
    lib = _load()
    return int(lib.walnuts_native_leapfrog_bench(
        TARGET_IDS[target], dim, n_steps, h, seed))
