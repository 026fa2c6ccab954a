"""Time builds of the BPTT library against each other on one card.

    python3 tools/bench_bptt_builds.py [name=path/to/lstm_bptt.cu ...]

Builds the repository's ``csrc/lstm_bptt.cu`` (as ``repo``) and every
source given (a variant, or the parent commit's copy unpacked beside the
checkout) with the port's nvcc flags, each into its own library, and checks
each ``lstm_bptt_launch`` (and, where the build takes the shape, its
``lstm_gates_launch``) against the plain loop at every shape of
``SHAPES``, and each build's pre-pass bitwise against the first build's
(``prepass_bitwise_as_first``); a build that refuses a shape prints its
``launch_error``.  At the timed shapes (``TIMED``: the train step's B = 64
at H = 256 and 512, and the NPSS voice's H = 1024 decoder cells at the
recipe's 64 x 128 and stage 5's 4 x 128) it times the whole launch and
the gate pre-pass alone by device time from CUDA events, in turns (a, b,
..., b, a, a, b, ...), and prints one JSON line per build and shape, with
the loop's time (``loop_ms``: launch minus pre-pass, turn by turn) and the
loop kernel the build's dispatch chose where it exports
``lstm_bptt_kernel_for``.  At H = 1024 it also times cuDNN's LSTM backward
on the same recurrence (``chip_smoke.cudnn_lstm_bwd_ms``: its input-side
GEMMs included, and timed alone) before and after the turns, as
``cudnn_bwd`` lines.  A build that exports
``lstm_bptt_debug(unsigned long long out[4][8])`` (per-phase clock sums of
an instrumented loop) has them printed per step after its check.  Needs
one CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import cudnn_lstm_bwd_ms  # noqa: E402
from ensemble_svs_with_interactions_tpu_torch.ops import (  # noqa: E402
    lstm_recurrence as lr,
)

TIMED = [(64, 256, 512), (64, 256, 256), (64, 64, 256), (64, 128, 1024),
         (4, 128, 1024)]
# checked only: ragged widths and batches of each loop kernel; at
# H = 1024 the FMA and tensor-core paths (8, 9 rows), a ragged row tile
# (65), two launches (600) and a batch the H > 512 loop before
# lstm_bptt_mma_kernel refused (3072 rows)
SHAPES = TIMED + [(67, 37, 98), (300, 9, 512), (4, 1000, 512),
                  (8, 37, 1024), (9, 37, 1024), (65, 9, 1024),
                  (600, 3, 1024), (17, 33, 1000), (4, 301, 640),
                  (3072, 2, 1024)]
CUDNN_H = 1024  # widths whose timed shapes carry cuDNN's backward beside


def bind_bptt(lib):
    lr._bind(lib, "lstm_bptt_launch", *[lr._PTR] * 7, lr._INT, lr._INT,
             lr._INT, lr._PTR)
    lr._bind(lib, "lstm_gates_launch", *[lr._PTR] * 4, lr._INT, lr._INT,
             lr._INT, lr._PTR)
    if hasattr(lib, "lstm_bptt_kernel_for"):
        lr._bind(lib, "lstm_bptt_kernel_for", lr._INT, lr._INT,
                 restype=ctypes.c_char_p)


def build_all(sources: dict, out: Path, bind=bind_bptt) -> dict:
    """{name: ctypes library}, one nvcc per source, all started at once,
    each library's entry points declared by ``bind``."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = lr._find_nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *lr.NVCC_FLAGS, "-I", str(lr.CSRC), "-o",
         str(out / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-3000:]}", file=sys.stderr)
            continue
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        bind(lib)
        libs[name] = lib
    return libs


def device_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cudnn_row(xw, w_h, dy, B, T, H):
    """cuDNN's LSTM backward on the same recurrence: its ms and that of its
    input-side GEMMs, which the port's BPTT does not do."""
    ms, gemm_ms = cudnn_lstm_bwd_ms(xw, w_h, dy, 5)
    return {"build": "cudnn_bwd", "B": B, "T": T, "H": H, "ms": ms,
            "input_gemm_ms": gemm_ms,
            "tf32": torch.backends.cudnn.allow_tf32}


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_bptt_builds: no CUDA device", file=sys.stderr)
        return 2
    sources = {"repo": lr.SOURCES["lstm_bptt"]}
    for arg in sys.argv[1:]:
        name, path = arg.split("=", 1)
        sources[name] = Path(path)
    libs = build_all(sources, REPO / "ensemble_svs_with_interactions_tpu_torch"
                     / "_build" / "bench_bptt_builds")
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for B, T, H in SHAPES:
        xw = torch.randn(B, T, 4 * H, device="cuda", generator=g)
        w_h = torch.randn(H, 4 * H, device="cuda", generator=g) / H ** 0.5
        dy = torch.randn(B, T, H, device="cuda", generator=g)
        h, c = lr.lstm_recurrence_reference(xw, w_h, want_c=True)
        dxw_ref = lr.lstm_recurrence_bwd_reference(xw, w_h, h, c, dy)[0]
        gates_ref = lr.lstm_gates_reference(xw, w_h, h)
        dxw, gates = torch.empty_like(xw), torch.empty_like(xw)
        # enough zeroed barrier counters for any build's plan
        counters = torch.zeros(B, device="cuda", dtype=torch.int32)
        rows = {}
        first_gates = None  # the first build's pre-pass, for bitwise checks
        for name, lib in libs.items():
            def bptt(lib=lib):
                counters.zero_()
                return lib.lstm_bptt_launch(
                    xw.data_ptr(), w_h.data_ptr(), h.data_ptr(), c.data_ptr(),
                    dy.data_ptr(), dxw.data_ptr(), counters.data_ptr(), B, T,
                    H, stream)

            def prepass(lib=lib):
                return lib.lstm_gates_launch(
                    xw.data_ptr(), w_h.data_ptr(), h.data_ptr(),
                    gates.data_ptr(), B, T, H, stream)

            row = {"build": name, "B": B, "T": T, "H": H,
                   "launch_error": bptt()}
            if hasattr(lib, "lstm_bptt_kernel_for"):
                row["kernel"] = lib.lstm_bptt_kernel_for(B, H).decode()
            if row["launch_error"]:
                print(json.dumps(row), flush=True)
                continue
            torch.cuda.synchronize()
            row["max_abs_err"] = (dxw - dxw_ref).abs().max().item()
            if hasattr(lib, "lstm_bptt_debug"):
                clocks = (ctypes.c_ulonglong * 32)()
                lib.lstm_bptt_debug(clocks)
                row["phase_cycles_per_step"] = [
                    [round(clocks[8 * s + k] / T) for k in range(6)]
                    for s in range(4)]
            if prepass() == 0:
                torch.cuda.synchronize()
                row["prepass_max_abs_err"] = (
                    gates - gates_ref).abs().max().item()
                if first_gates is None:
                    first_gates = gates.clone()
                else:
                    row["prepass_bitwise_as_first"] = torch.equal(
                        gates, first_gates)
            else:
                prepass = None
            rows[name] = (row, bptt, prepass)
        timed = (B, T, H) in TIMED
        cudnn = timed and H == CUDNN_H
        if cudnn:
            print(json.dumps(cudnn_row(xw, w_h, dy, B, T, H)), flush=True)
        if timed:
            names = list(rows)
            for name in names + names[::-1] + names:
                row, bptt, prepass = rows[name]
                row.setdefault("ms", []).append(device_ms(bptt, 20))
                if prepass is not None:
                    row.setdefault("prepass_ms", []).append(
                        device_ms(prepass, 50))
                    row.setdefault("loop_ms", []).append(
                        row["ms"][-1] - row["prepass_ms"][-1])
        for row, _, _ in rows.values():
            print(json.dumps(row), flush=True)
        if cudnn:
            print(json.dumps(cudnn_row(xw, w_h, dy, B, T, H)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
