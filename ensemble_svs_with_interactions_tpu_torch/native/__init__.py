"""Native (C++) kernels of the host-side WORLD analysis, bound with ctypes.

The port's copy of ``ensemble_svs_with_interactions_tpu/native/``:
``world_kernels.cpp`` is the JAX package's source byte for byte (a CPU
test holds them equal); it holds fused per-frame kernels for the
analysis stack of ``ops/world/analysis.py`` (NCCF candidates, the
instantiated-frequency F0 refinement, CheapTrick, D4C's band
aperiodicity and its periodicity gate).

The shared library is compiled at first use with ``g++ -O3 -std=c++17
-shared -fPIC -fno-math-errno`` into the package's ``_build/`` (ignored by
git); the build writes a temporary file and renames it into place, since
the feature-extraction process pool races the first build.  ``lib()``
returns None, and callers take the vectorized NumPy path of
``ops/world/analysis.py``, when no compiler is present, the build fails,
or ``ESVS_DISABLE_NATIVE=1``.  A cached library that fails to load or
lacks an export is rebuilt once, else the NumPy path serves.  This is
the JAX package's behaviour for host code, not a device fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "world_kernels.cpp"
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fno-math-errno")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_int64_p = ctypes.POINTER(ctypes.c_int64)


def _so_path() -> Path:
    tag = sysconfig.get_platform().replace("-", "_").replace(".", "_")
    return BUILD_DIR / f"_world_kernels_{tag}.so"


def _build(so: Path) -> bool:
    # a unique temporary file renamed into place: linking onto the final
    # path would truncate a library another worker process has loaded
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode == 0 and tmp.exists():
            os.replace(tmp, so)
            return True
        return False
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, f64 = ctypes.c_int64, ctypes.c_double
    lib.esvs_cheaptrick.restype = None
    lib.esvs_cheaptrick.argtypes = [
        _c_double_p, i64,                  # x, n
        _c_double_p, _c_int64_p, i64,      # f0_safe, centers, T
        i64, i64,                          # fs, fft_size
        f64, f64,                          # q1, noise_calibration
        _c_double_p,                       # env out (T, half+1)
    ]
    lib.esvs_nccf.restype = None
    lib.esvs_nccf.argtypes = [
        _c_double_p, i64,                  # x, n
        _c_int64_p, i64,                   # centers, T
        i64,                               # fs
        f64, f64,                          # f0_floor, f0_ceil
        i64,                               # K
        _c_double_p, _c_double_p, _c_double_p,  # f0_cand, score, energy
    ]
    lib.esvs_refine_if.restype = None
    lib.esvs_refine_if.argtypes = [
        _c_double_p, i64,                  # x, n
        _c_double_p, _c_int64_p, i64,      # est (in and out), centers, T
        i64,                               # fs
        f64, i64, i64,                     # periods, n_harm, iters
    ]
    lib.esvs_d4c_coarse.restype = None
    lib.esvs_d4c_coarse.argtypes = [
        _c_double_p, i64,                  # x, n
        _c_double_p, _c_int64_p, i64,      # period (samples), centers, T
        i64, i64,                          # fft_size, L_long
        i64,                               # fs
        f64,                               # freq_interval
        i64,                               # n_bands
        _c_double_p,                       # coarse out (T, n_bands)
    ]
    lib.esvs_periodicity.restype = None
    lib.esvs_periodicity.argtypes = [
        _c_double_p, i64,                  # x, n
        _c_double_p, _c_int64_p, i64,      # f0_safe, centers, T
        i64, i64,                          # fs, max_lag
        _c_double_p,                       # periodicity out (T,)
    ]
    return lib


def lib() -> Optional[ctypes.CDLL]:
    """The loaded kernel library, built on first use; None when it cannot
    be built or ``ESVS_DISABLE_NATIVE=1``."""
    global _LIB, _TRIED
    if os.environ.get("ESVS_DISABLE_NATIVE", "0") == "1":
        return None
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        so = _so_path()
        try:
            if not so.exists() or so.stat().st_mtime < _SRC.stat().st_mtime:
                if not _build(so):
                    _TRIED = True
                    return None
            _LIB = _declare(ctypes.CDLL(str(so)))
        except (OSError, AttributeError):
            # a stale or foreign library (AttributeError: an export is
            # missing): rebuild once, else the NumPy path serves
            try:
                so.unlink(missing_ok=True)
                if _build(so):
                    _LIB = _declare(ctypes.CDLL(str(so)))
            except (OSError, AttributeError):
                _LIB = None
        _TRIED = True
        return _LIB


def available() -> bool:
    """Whether the native kernels serve the analysis (``lib()`` loaded)."""
    return lib() is not None


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


# ------------------------------------------- NumPy-facing wrappers
# contiguous float64 / int64 in, float64 out


def cheaptrick(x, f0_safe, centers, fs: int, fft_size: int, q1: float,
               noise_calibration: float) -> np.ndarray:
    L = lib()
    assert L is not None
    x = np.ascontiguousarray(x, np.float64)
    f0_safe = np.ascontiguousarray(f0_safe, np.float64)
    centers = np.ascontiguousarray(centers, np.int64)
    T = len(f0_safe)
    env = np.empty((T, fft_size // 2 + 1), np.float64)
    L.esvs_cheaptrick(
        _ptr(x, _c_double_p), len(x),
        _ptr(f0_safe, _c_double_p), _ptr(centers, _c_int64_p), T,
        fs, fft_size, q1, noise_calibration,
        _ptr(env, _c_double_p),
    )
    return env


def nccf(x, centers, fs: int, f0_floor: float, f0_ceil: float, K: int):
    L = lib()
    assert L is not None
    x = np.ascontiguousarray(x, np.float64)
    centers = np.ascontiguousarray(centers, np.int64)
    T = len(centers)
    f0_cand = np.empty((T, K), np.float64)
    score = np.empty((T, K), np.float64)
    energy = np.empty((T,), np.float64)
    L.esvs_nccf(
        _ptr(x, _c_double_p), len(x),
        _ptr(centers, _c_int64_p), T, fs, f0_floor, f0_ceil, K,
        _ptr(f0_cand, _c_double_p), _ptr(score, _c_double_p),
        _ptr(energy, _c_double_p),
    )
    return f0_cand, score, energy


def refine_if(x, est, centers, fs: int, periods: float, n_harm: int,
              iters: int) -> np.ndarray:
    L = lib()
    assert L is not None
    x = np.ascontiguousarray(x, np.float64)
    est = np.array(est, np.float64)  # a copy: the kernel refines in place
    centers = np.ascontiguousarray(centers, np.int64)
    L.esvs_refine_if(
        _ptr(x, _c_double_p), len(x),
        _ptr(est, _c_double_p), _ptr(centers, _c_int64_p), len(est),
        fs, periods, n_harm, iters,
    )
    return est


def d4c_coarse(x, period, centers, fs: int, fft_size: int, L_long: int,
               freq_interval: float, n_bands: int) -> np.ndarray:
    L = lib()
    assert L is not None
    x = np.ascontiguousarray(x, np.float64)
    period = np.ascontiguousarray(period, np.float64)
    centers = np.ascontiguousarray(centers, np.int64)
    T = len(period)
    coarse = np.empty((T, n_bands), np.float64)
    L.esvs_d4c_coarse(
        _ptr(x, _c_double_p), len(x),
        _ptr(period, _c_double_p), _ptr(centers, _c_int64_p), T,
        fft_size, L_long, fs, freq_interval, n_bands,
        _ptr(coarse, _c_double_p),
    )
    return coarse


def periodicity(x, f0_safe, centers, fs: int, max_lag: int) -> np.ndarray:
    L = lib()
    assert L is not None
    x = np.ascontiguousarray(x, np.float64)
    f0_safe = np.ascontiguousarray(f0_safe, np.float64)
    centers = np.ascontiguousarray(centers, np.int64)
    T = len(f0_safe)
    out = np.empty((T,), np.float64)
    L.esvs_periodicity(
        _ptr(x, _c_double_p), len(x),
        _ptr(f0_safe, _c_double_p), _ptr(centers, _c_int64_p), T,
        fs, max_lag, _ptr(out, _c_double_p),
    )
    return out
