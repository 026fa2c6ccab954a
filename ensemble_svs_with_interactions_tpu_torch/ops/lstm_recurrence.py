"""LSTM recurrence over precomputed input projections, and its reverse-time
backward: the Hopper kernels, their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

Replaces ``ensemble_svs_with_interactions_tpu/ops/pallas_lstm.py``:

* ``_lstm_kernel`` (hidden sequence only) and, with ``want_c=True``,
  ``_lstm_fwd_kernel`` (hidden and cell sequences, the residual the backward
  needs): :func:`lstm_recurrence`, kernel ``csrc/lstm_recurrence.cu``;
* ``_lstm_bwd_kernel`` (reverse-time BPTT: the gate gradient dxw and dW_h):
  :func:`lstm_bptt` (a gate pre-pass, :func:`lstm_gates`, then the reverse
  loop; H <= 1024) and :func:`lstm_dwh`, kernels ``csrc/lstm_bptt.cu``;
* the custom VJP ``lstm_recurrence_trainable``:
  :class:`LSTMRecurrence` / :func:`lstm_recurrence_trainable`.  The v5e
  block sizing ``trainable_auto_blocks`` has no counterpart: the kernels
  plan their own launch (``csrc/lstm_common.cuh``).

Each CUDA source is compiled for ``sm_90a`` with its own ``nvcc`` (the two
run at once) into ``_build/`` at first use and called through a plain C
interface with ``ctypes``.

What bounds the recurrence kernels on the card: the sequential time loop.
Each of the T steps needs the whole previous hidden vector (forward) or
the whole previous gate gradient (backward), and its (B, H) x (H, 4H)
products are far too small to fill the card, so a step costs its latency,
not bytes or FLOPs.  The designs keep everything that does not change
across steps on chip (see the headers of the CUDA sources):

* the BPTT first computes every step's gates in a parallel pre-pass (at
  H > 64 a 3xTF32 tensor-core product), so only dh and the cell
  arithmetic stay in its loop;
* H <= 64, forward and BPTT loop: one block per batch row owns all units,
  W_h sits in registers at a compile-time padded width of 32 or 64, the
  sums of a step meet through a warp shuffle, and a step ends at one
  ``__syncthreads``;
* 64 < H <= 512, forward and BPTT loop: the grid splits the units and
  the batch, each block holds the rows of W_h of its 16 units in
  registers, and only the blocks that share a group of batch rows
  exchange h (forward) or dz (BPTT) and meet at a barrier;
* 512 < H <= 1024, forward: each block owns 8 units (their 32 gate
  columns) for every batch row and does a step's (B, H) x (H, 32)
  product for all rows at once on the tensor cores, in 3xTF32
  ``mma.sync`` (float32-accurate), split over its 8 warps by the hidden
  units of h, each warp's part of W_h in registers for the whole
  sequence; h_{t-1} streams from L2 through a ``cp.async`` ring, the
  warps' partial sums meet in shared memory in a fixed order, and any
  batch runs in tiles of 64 rows (launches of up to 512 rows);
* 512 < H <= 1024, BPTT loop: clusters of two blocks, each cluster owning
  16 units for every batch row; a reverse step's (B, 4H) x (4H, 16)
  product, dz_{t+1} times its rows of W_h transposed, is split by the gate
  columns between the two blocks, and each multiplies all rows at once in
  3xTF32 ``mma.sync``, split over its 8 warps, each warp's part of W_h in
  registers; its half of dz_{t+1} streams from L2 through a ``cp.async``
  ring, the halves' sums meet through the cluster's shared memory in a
  fixed order, launches of at most 8 rows take float32 FMAs, and any batch
  runs in tiles of 64 rows (launches of up to 512 rows).
* Wider LSTMs raise, forward and backward: a warp's part of W_h would
  outgrow its registers.

dW_h is a tiled product over all steps, run after the loop, bound by the
tensor cores' rate: 3xTF32 ``mma.sync`` (float32-accurate), fed by a
``cp.async`` ring and split over the reduction with a fixed-order sum, so
it is deterministic.

Gate math is flax ``OptimizedLSTMCell``'s (order i, f, g, o, all f32):
``c' = sig(f) c + sig(i) tanh(g)``, ``h' = sig(o) tanh(c')``, with
``h_0 = c_0 = 0``.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
SOURCES = {"lstm_recurrence": CSRC / "lstm_recurrence.cu",
           "lstm_bptt": CSRC / "lstm_bptt.cu"}
HEADERS = (CSRC / "lstm_common.cuh",)
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


# ------------------------------------------------------------ plain versions
def lstm_recurrence_reference(xw, w_h, want_c: bool = False):
    """Plain PyTorch loop over T: the kernel's arithmetic, step by step.

    xw (B, T, 4H), w_h (H, 4H) -> y (B, T, H), and also the cell sequence
    c (B, T, H) when ``want_c``.  Any float dtype (float64 for gradcheck).
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


def _shift(seq):
    """seq (B, T, H) -> the same one step later, zero at t = 0."""
    return torch.cat([torch.zeros_like(seq[:, :1]), seq[:, :-1]], dim=1)


def lstm_gates_reference(xw, w_h, h):
    """The activated gates (B, T, 4H) the BPTT recomputes: i, f, g, o =
    sig, sig, tanh, sig of ``xw_t + h_{t-1} W_h`` (h_{-1} = 0), the gate
    pre-pass's arithmetic.  xw (B, T, 4H), w_h (H, 4H), h (B, T, H) from
    the forward; any float dtype."""
    T, H = xw.shape[1], xw.shape[2] // 4
    hprev = _shift(h)
    gates = torch.empty_like(xw)
    for t in range(T):
        zi, zf, zg, zo = (xw[:, t] + hprev[:, t] @ w_h).split(H, dim=1)
        gates[:, t] = torch.cat([torch.sigmoid(zi), torch.sigmoid(zf),
                                 torch.tanh(zg), torch.sigmoid(zo)], dim=1)
    return gates


def lstm_bptt_loop_reference(gates, w_h, c, dy):
    """Plain reverse-time loop over the gates of :func:`lstm_gates_reference`:
    gates (B, T, 4H), w_h (H, 4H), c (B, T, H) from the forward, dy
    (B, T, H) the gradient into h -> dxw (B, T, 4H), the loop kernel's
    arithmetic; any float dtype."""
    B, T, H4 = gates.shape
    H = H4 // 4
    i, f, g, o = gates.split(H, dim=2)
    # dz = ((d u) v) w per gate, d = dc for i, f, g and dh tanh(c_t) for o,
    # the step's factors u, v, w computed for every step at once (exact
    # products and differences, and a factor 1 that multiplies exactly):
    # the step-by-step formula's dc g i (1 - i), dc c_{t-1} f (1 - f),
    # dc i (1 - g^2), dh tanh(c_t) o (1 - o), in its order and bits
    one = torch.ones_like(g)
    u = torch.cat([g, _shift(c), i, one], dim=2)
    v = torch.cat([i, f, one, o], dim=2)
    w = torch.cat([1.0 - i, 1.0 - f, 1.0 - g * g, 1.0 - o], dim=2)
    dxw = torch.empty_like(gates)
    dh_next = gates.new_zeros(B, H)
    dc_next = gates.new_zeros(B, H)
    for t in range(T - 1, -1, -1):
        tc = torch.tanh(c[:, t])
        dh = dy[:, t] + dh_next
        dc = dh * o[:, t] * (1.0 - tc * tc) + dc_next
        dz = (torch.cat([dc, dc, dc, dh * tc], dim=1) * u[:, t] * v[:, t]
              * w[:, t])
        dxw[:, t] = dz
        dh_next = dz @ w_h.t()
        dc_next = dc * f[:, t]
    return dxw


def lstm_recurrence_bwd_reference(xw, w_h, h, c, dy):
    """Plain reverse-time BPTT, ``_lstm_bwd_kernel``'s arithmetic: the gates
    recomputed from ``xw_t + h_{t-1} W_h`` (:func:`lstm_gates_reference`),
    the reverse loop (:func:`lstm_bptt_loop_reference`) and dW_h summed
    step by step in reverse time.

    xw (B, T, 4H), w_h (H, 4H), h and c (B, T, H) from the forward, dy
    (B, T, H) the gradient into h -> (dxw (B, T, 4H), dwh (H, 4H)); any
    float dtype.
    """
    dxw = lstm_bptt_loop_reference(lstm_gates_reference(xw, w_h, h), w_h,
                                   c, dy)
    hprev = _shift(h)
    dwh = torch.zeros_like(w_h)
    for t in range(xw.shape[1] - 1, -1, -1):
        dwh += hprev[:, t].t() @ dxw[:, t]
    return dxw, dwh


def lstm_dwh_reference(h, dz):
    """dW_h (H, 4H) = sum over b, t of h_{t-1}^T dz_t (h_{-1} = 0)."""
    return torch.einsum("bti,btn->in", _shift(h), dz)


# ------------------------------------------------------------------- build
def _find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
        if nvcc.exists():
            return str(nvcc)
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the LSTM kernels cannot be built")
    return nvcc


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes() + b"".join(
        p.read_bytes() for p in HEADERS)).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


_BUILD_LOCK = threading.Lock()


def build() -> dict:
    """Compile every kernel source into ``_build/`` (keyed by the hash of
    the source and the shared header, so an edit is rebuilt), one ``nvcc``
    per source, all started together.  Returns {name: library path}.
    nvcc's report (registers, shared memory, spills) is kept beside each
    library as ``.log``.  One thread builds at a time (a server's first
    requests may arrive together), and one process: the ranks of a
    data-parallel run start together on a clean ``_build/``, so the first
    to take the file lock ``_build/.lock`` builds and the rest wait for
    it and load its libraries."""
    with _BUILD_LOCK:
        libs = {name: _library_path(name) for name in SOURCES}
        if all(lib.exists() for lib in libs.values()):
            return libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when it closes
            return _build_missing(libs)


def _build_missing(libs: dict) -> dict:
    """Run ``nvcc`` on each source whose library is missing (another
    process may have built them while this one waited for the lock)."""
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    nvcc = _find_nvcc()
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}) on "
                            f"{SOURCES[name]}:\n{out}")
            continue
        libs[name].with_suffix(".log").write_text(out)
        os.replace(tmp, libs[name])  # atomic: no one sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _bind(lib, name, *argtypes, restype=_INT):
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()["lstm_recurrence"]))
    _bind(lib, "lstm_recurrence_launch", *[_PTR] * 5, _INT, _INT, _INT, _PTR)
    _bind(lib, "lstm_recurrence_counters", _INT, _INT)
    _bind(lib, "lstm_recurrence_kernel_for", _INT, _INT,
          restype=ctypes.c_char_p)
    _bind(lib, "lstm_recurrence_error_string", _INT, restype=ctypes.c_char_p)
    return lib


@functools.lru_cache(maxsize=None)
def _bptt_library():
    lib = ctypes.CDLL(str(build()["lstm_bptt"]))
    _bind(lib, "lstm_bptt_launch", *[_PTR] * 7, _INT, _INT, _INT, _PTR)
    _bind(lib, "lstm_bptt_counters", _INT, _INT)
    _bind(lib, "lstm_bptt_kernel_for", _INT, _INT, restype=ctypes.c_char_p)
    _bind(lib, "lstm_gates_launch", *[_PTR] * 4, _INT, _INT, _INT, _PTR)
    _bind(lib, "lstm_dwh_splits", _INT, _INT, _INT)
    _bind(lib, "lstm_dwh_launch", *[_PTR] * 4, _INT, _INT, _INT, _INT, _PTR)
    _bind(lib, "lstm_bptt_error_string", _INT, restype=ctypes.c_char_p)
    return lib


# ---------------------------------------------------------------- wrappers
def _check_cuda(fn: str, ref, **tensors):
    """Raise unless every tensor is float32 on ``ref``'s CUDA device, and
    return them contiguous (a copy where one is not)."""
    if ref.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {ref.device}")
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{fn}: {name} on {t.device}, not {ref.device}")
    return [t.contiguous() for t in tensors.values()]


def _check_shapes(fn: str, xw, w_h, **seqs):
    B, T, H4 = xw.shape
    H = H4 // 4
    ok = H4 == 4 * H and tuple(w_h.shape) == (H, H4) and all(
        tuple(s.shape) == (B, T, H) for s in seqs.values())
    if not ok:
        shapes = {k: tuple(v.shape) for k, v in seqs.items()}
        raise ValueError(
            f"{fn}: xw {tuple(xw.shape)}, w_h {tuple(w_h.shape)} and "
            f"{shapes} do not form (B, T, 4H), (H, 4H) and (B, T, H)")
    return B, T, H


def _raise_launch(fn, lib_err, err, **dims):
    msg = lib_err(err).decode()
    where = ", ".join(f"{k}={v}" for k, v in dims.items())
    raise RuntimeError(f"{fn} kernel ({where}) failed to launch: CUDA error "
                       f"{err}: {msg}")


# renders on several threads (``SPSVS.svs_streaming``, the NEUTRINO
# server) launch at once: the counts are kept under one lock
_COUNT_LOCK = threading.Lock()


def _count(wrapper, H=None):
    """Add one launch to ``wrapper``'s count (and to its count by width
    ``H``, the forward's)."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if H is not None:
            wrapper.launches_by_width[H] += 1


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


SMALL_H = 64  # kSmallH of csrc/lstm_common.cuh
MAX_FORWARD_H = 1024  # kMaxMmaH of csrc/lstm_recurrence.cu
MAX_BPTT_H = 1024  # kMaxBpttH of csrc/lstm_bptt.cu


def lstm_recurrence(xw, w_h, want_c: bool = False):
    """The LSTM recurrence: the hand-written kernel on a CUDA tensor, the
    plain version on a CPU tensor.  Same contract as
    :func:`lstm_recurrence_reference`.  On the card it launches the kernel
    or raises; there is no fallback."""
    if xw.device.type == "cpu":
        return lstm_recurrence_reference(xw, w_h, want_c)
    B, T, H = _check_shapes("lstm_recurrence", xw, w_h)
    if H > MAX_FORWARD_H:
        raise ValueError(f"lstm_recurrence: H = {H}, the kernels take H <= "
                         f"{MAX_FORWARD_H}")
    xw, w_h = _check_cuda("lstm_recurrence", xw, xw=xw, w_h=w_h)
    if H <= SMALL_H and xw.data_ptr() % 16:
        xw = xw.clone()  # that kernel streams xw rows in 16-byte copies
    y = torch.empty(B, T, H, device=xw.device, dtype=torch.float32)
    c = torch.empty_like(y) if want_c else None
    if B == 0 or T == 0:
        return (y, c) if want_c else y
    lib = _library()
    with torch.cuda.device(xw.device):
        counters = torch.zeros(lib.lstm_recurrence_counters(B, H),
                               device=xw.device, dtype=torch.int32)
        err = lib.lstm_recurrence_launch(
            xw.data_ptr(), w_h.data_ptr(), y.data_ptr(),
            c.data_ptr() if want_c else None, counters.data_ptr(), B, T, H,
            _stream(xw))
    if err != 0:
        _raise_launch("lstm_recurrence", lib.lstm_recurrence_error_string,
                      err, B=B, T=T, H=H)
    _count(lstm_recurrence, H)
    return (y, c) if want_c else y


def lstm_recurrence_kernel_name(B: int, H: int) -> str:
    """The name of the kernel :func:`lstm_recurrence` launches for a batch
    of B rows at width H (the rule in ``csrc/lstm_recurrence.cu``, above
    ``lstm_recurrence_launch``).  Builds the library at first use."""
    return _library().lstm_recurrence_kernel_for(B, H).decode()


def lstm_bptt_kernel_name(B: int, H: int) -> str:
    """The name of the loop kernel :func:`lstm_bptt` launches after its
    gate pre-pass for a batch of B rows at width H (the rule in
    ``csrc/lstm_bptt.cu``, above ``lstm_bptt_launch``).  Builds the library
    at first use."""
    return _bptt_library().lstm_bptt_kernel_for(B, H).decode()


def lstm_bptt(xw, w_h, h, c, dy):
    """The gate gradient dxw (B, T, 4H) of the reverse-time BPTT: the
    hand-written kernels on a CUDA tensor (the gate pre-pass and the
    reverse loop, both counted as one launch; H <= 1024), the plain loop on
    a CPU tensor.  Inputs as :func:`lstm_recurrence_bwd_reference`."""
    if xw.device.type == "cpu":
        return lstm_bptt_loop_reference(lstm_gates_reference(xw, w_h, h), w_h,
                                        c, dy)
    B, T, H = _check_shapes("lstm_bptt", xw, w_h, h=h, c=c, dy=dy)
    if H > MAX_BPTT_H:
        raise ValueError(f"lstm_bptt: H = {H}, the kernels take H <= "
                         f"{MAX_BPTT_H}")
    xw, w_h, h, c, dy = _check_cuda("lstm_bptt", xw, xw=xw, w_h=w_h, h=h,
                                    c=c, dy=dy)
    dxw = torch.empty(B, T, 4 * H, device=xw.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return dxw
    lib = _bptt_library()
    with torch.cuda.device(xw.device):
        counters = torch.zeros(lib.lstm_bptt_counters(B, H),
                               device=xw.device, dtype=torch.int32)
        err = lib.lstm_bptt_launch(
            xw.data_ptr(), w_h.data_ptr(), h.data_ptr(), c.data_ptr(),
            dy.data_ptr(), dxw.data_ptr(), counters.data_ptr(), B, T, H,
            _stream(xw))
    if err != 0:
        _raise_launch("lstm_bptt", lib.lstm_bptt_error_string, err,
                      B=B, T=T, H=H)
    _count(lstm_bptt)
    return dxw


def lstm_gates(xw, w_h, h):
    """The gate pre-pass of :func:`lstm_bptt` alone, for tests and timing:
    the hand-written kernel on a CUDA tensor (``lstm_gates_kernel`` at
    H <= 64, ``lstm_gates_mma_kernel`` above), the plain version on a CPU
    tensor.  Same contract as :func:`lstm_gates_reference`."""
    if xw.device.type == "cpu":
        return lstm_gates_reference(xw, w_h, h)
    B, T, H = _check_shapes("lstm_gates", xw, w_h, h=h)
    xw, w_h, h = _check_cuda("lstm_gates", xw, xw=xw, w_h=w_h, h=h)
    gates = torch.empty(B, T, 4 * H, device=xw.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return gates
    lib = _bptt_library()
    with torch.cuda.device(xw.device):
        err = lib.lstm_gates_launch(xw.data_ptr(), w_h.data_ptr(),
                                    h.data_ptr(), gates.data_ptr(), B, T, H,
                                    _stream(xw))
    if err != 0:
        _raise_launch("lstm_gates", lib.lstm_bptt_error_string, err,
                      B=B, T=T, H=H)
    _count(lstm_gates)
    return gates


def lstm_dwh(h, dz):
    """dW_h (H, 4H) = sum over b, t of h_{t-1}^T dz_t: the hand-written
    tiled reduction on a CUDA tensor, the plain version on a CPU tensor."""
    if h.device.type == "cpu":
        return lstm_dwh_reference(h, dz)
    B, T, H = h.shape
    if tuple(dz.shape) != (B, T, 4 * H):
        raise ValueError(f"lstm_dwh: h {tuple(h.shape)} and dz "
                         f"{tuple(dz.shape)} do not form (B, T, H) and "
                         "(B, T, 4H)")
    h, dz = _check_cuda("lstm_dwh", h, h=h, dz=dz)
    dwh = torch.empty(H, 4 * H, device=h.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return dwh.zero_()
    lib = _bptt_library()
    with torch.cuda.device(h.device):
        splits = lib.lstm_dwh_splits(B, T, H)
        part = (torch.empty(splits, H, 4 * H, device=h.device,
                            dtype=torch.float32) if splits > 1 else None)
        err = lib.lstm_dwh_launch(
            h.data_ptr(), dz.data_ptr(), dwh.data_ptr(),
            part.data_ptr() if part is not None else None, B, T, H, splits,
            _stream(h))
    if err != 0:
        _raise_launch("lstm_dwh", lib.lstm_bptt_error_string, err,
                      B=B, T=T, H=H)
    _count(lstm_dwh)
    return dwh


def lstm_recurrence_bwd(xw, w_h, h, c, dy):
    """(dxw, dwh) of the recurrence: :func:`lstm_bptt` then
    :func:`lstm_dwh` on the card, the plain loop on the CPU."""
    if xw.device.type == "cpu":
        return lstm_recurrence_bwd_reference(xw, w_h, h, c, dy)
    dxw = lstm_bptt(xw, w_h, h, c, dy)
    return dxw, lstm_dwh(h, dxw)


# kernel launches since the count was last reset (the plain versions and
# failed launches are not counted); the forward's also by hidden width
lstm_recurrence.launches = 0
lstm_recurrence.launches_by_width = collections.Counter()
lstm_bptt.launches = 0
lstm_gates.launches = 0
lstm_dwh.launches = 0


class LSTMRecurrence(torch.autograd.Function):
    """The differentiable recurrence, counterpart of the custom VJP
    ``lstm_recurrence_trainable``: the forward runs
    :func:`lstm_recurrence` with ``want_c`` and saves (xw, W_h, h, c); the
    backward runs :func:`lstm_recurrence_bwd`: the BPTT and dW_h kernels
    on a CUDA tensor, the plain loop on a CPU tensor."""

    @staticmethod
    def forward(ctx, xw, w_h):
        h, c = lstm_recurrence(xw, w_h, want_c=True)
        ctx.save_for_backward(xw, w_h, h, c)
        return h

    @staticmethod
    def backward(ctx, dy):
        xw, w_h, h, c = ctx.saved_tensors
        return lstm_recurrence_bwd(xw, w_h, h, c, dy)


def lstm_recurrence_trainable(xw, w_h):
    """(B, T, H) hidden states, differentiable in ``xw`` and ``w_h``."""
    return LSTMRecurrence.apply(xw, w_h)
