"""LSTM recurrence over precomputed input projections: the Hopper kernel
and its plain PyTorch version.

Replaces ``ensemble_svs_with_interactions_tpu/ops/pallas_lstm.py``:
``_lstm_kernel`` (hidden sequence only) and, with ``want_c=True``,
``_lstm_fwd_kernel`` (hidden and cell sequences, the residual a BPTT
backward needs).  The kernel is ``csrc/lstm_recurrence.cu``, compiled for
``sm_90a`` with ``nvcc`` into ``_build/`` at first use and called through
a plain C interface with ``ctypes``.

What bounds it on the card: the sequential time loop.  Each of the T steps
needs the whole previous hidden vector, and its (B, H) x (H, 4H) product is
far too small to fill the card, so a step costs its latency (reading
h_{t-1}, the product, the cell update, and at H > 64 a grid-wide barrier),
not bytes or FLOPs.  The design keeps everything that does not change
across steps on chip: each block holds its slice of W_h in shared memory
for the whole sequence, the hidden units are split across blocks so the
barrier is the only cross-block traffic, and at H <= 64 one block owns all
units and needs no barrier at all (see the header of the CUDA source).

Gate math is flax ``OptimizedLSTMCell``'s (order i, f, g, o, all f32):
``c' = sig(f) c + sig(i) tanh(g)``, ``h' = sig(o) tanh(c')``, with
``h_0 = c_0 = 0``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "lstm_recurrence.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def lstm_recurrence_reference(xw, w_h, want_c: bool = False):
    """Plain PyTorch loop over T: the kernel's arithmetic, step by step.

    xw (B, T, 4H) f32, w_h (H, 4H) f32 -> y (B, T, H), and also the cell
    sequence c (B, T, H) when ``want_c``.
    """
    B, T, H4 = xw.shape
    H = H4 // 4
    h = xw.new_zeros(B, H)
    c = xw.new_zeros(B, H)
    ys = xw.new_empty(B, T, H)
    cs = xw.new_empty(B, T, H) if want_c else None
    for t in range(T):
        z = xw[:, t] + h @ w_h
        i, f, g, o = z.split(H, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[:, t] = h
        if want_c:
            cs[:, t] = c
    return (ys, cs) if want_c else ys


def _find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
        if nvcc.exists():
            return str(nvcc)
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the LSTM recurrence kernel "
                           "cannot be built")
    return nvcc


def build() -> Path:
    """Compile the kernel into ``_build/`` (keyed by the source's hash, so
    an edited source is rebuilt) and return the shared library's path.
    nvcc's report (registers, shared memory, spills) is kept beside it as
    ``.log``."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"liblstm_recurrence_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()))
    lib.lstm_recurrence_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.lstm_recurrence_launch.restype = ctypes.c_int
    lib.lstm_recurrence_counters.argtypes = [ctypes.c_int]
    lib.lstm_recurrence_counters.restype = ctypes.c_int
    lib.lstm_recurrence_error_string.argtypes = [ctypes.c_int]
    lib.lstm_recurrence_error_string.restype = ctypes.c_char_p
    return lib


def lstm_recurrence(xw, w_h, want_c: bool = False):
    """The LSTM recurrence: the hand-written kernel on a CUDA tensor, the
    plain version on a CPU tensor.  Same contract as
    :func:`lstm_recurrence_reference`.  On the card it launches the kernel
    or raises; there is no fallback."""
    if xw.device.type == "cpu":
        return lstm_recurrence_reference(xw, w_h, want_c)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_recurrence: unsupported device {xw.device}")
    B, T, H4 = xw.shape
    H = H4 // 4
    if H4 != 4 * H or tuple(w_h.shape) != (H, H4):
        raise ValueError(
            f"lstm_recurrence: xw {tuple(xw.shape)} and w_h "
            f"{tuple(w_h.shape)} do not form (B, T, 4H) and (H, 4H)"
        )
    for name, t in (("xw", xw), ("w_h", w_h)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"lstm_recurrence: {name} must be contiguous "
                             f"float32, got {t.dtype}")
        if t.device != xw.device:
            raise ValueError("lstm_recurrence: xw and w_h on different "
                             "devices")
    y = torch.empty(B, T, H, device=xw.device, dtype=torch.float32)
    c = torch.empty_like(y) if want_c else None
    if B == 0 or T == 0:
        return (y, c) if want_c else y
    lib = _library()
    counters = torch.zeros(lib.lstm_recurrence_counters(B),
                           device=xw.device, dtype=torch.int32)
    err = lib.lstm_recurrence_launch(
        xw.data_ptr(), w_h.data_ptr(), y.data_ptr(),
        c.data_ptr() if want_c else None, counters.data_ptr(), B, T, H,
        torch.cuda.current_stream(xw.device).cuda_stream,
    )
    if err != 0:
        msg = lib.lstm_recurrence_error_string(err).decode()
        raise RuntimeError(
            f"lstm_recurrence kernel (B={B}, T={T}, H={H}) failed to "
            f"launch: CUDA error {err}: {msg}"
        )
    lstm_recurrence.launches += 1
    return (y, c) if want_c else y


# kernel launches since the count was last reset (the plain version and
# failed launches are not counted)
lstm_recurrence.launches = 0
