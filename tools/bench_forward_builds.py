"""Time builds of the forward recurrence library against each other on one
card.

    python3 tools/bench_forward_builds.py [name=path/to/lstm_recurrence.cu ...]

Builds the repository's ``csrc/lstm_recurrence.cu`` (as ``repo``) and every
source given (a variant, or the parent commit's copy unpacked beside the
checkout with its own ``lstm_common.cuh``) with the port's nvcc flags, each
into its own library, and checks each ``lstm_recurrence_launch`` against
the plain loop in both modes (h, and h with c; h bitwise equal between
them) at every shape of ``SHAPES``; a build that refuses a shape prints
its ``launch_error``.  At the timed shapes (the serving calls' B = 4,
T = 6656, h only; the train step's B = 64, h and c; the NPSS voice's
H = 1024 decoder cells at its train step's 64 x 128 and 4 x 128, with c,
and its dev pass's 1 x 1984, h only) it times the launch by device time
from CUDA events, in turns (a, b, ..., b, a, a, b, ...), and prints one
JSON line per build and shape, with the kernel the build's dispatch chose
where it exports ``lstm_recurrence_kernel_for``.  At H = 1024 it also
times cuDNN's LSTM call on the same recurrence (``chip_smoke.
cudnn_lstm_ms``: its input GEMM included, and timed alone) before and
after the turns, with cuDNN's TF32 allowed (PyTorch's default, which
that function leaves) and with it off, as the ``cudnn`` and ``cudnn_f32``
lines.  Needs one CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

from bench_bptt_builds import build_all, device_ms  # noqa: E402
from chip_smoke import cudnn_lstm_ms  # noqa: E402

from ensemble_svs_with_interactions_tpu_torch.ops import (  # noqa: E402
    lstm_recurrence as lr,
)

# (B, T, H, timed mode): None is checked only; False times h alone (the
# serving calls, the NPSS dev pass), True h and c (a train step's forward)
SHAPES = [(4, 6656, 512, False), (4, 6656, 256, False),
          (64, 256, 512, True), (64, 256, 256, True), (64, 64, 256, True),
          (64, 128, 1024, True), (4, 128, 1024, True),
          (1, 1984, 1024, False),
          (67, 37, 98, None), (5, 37, 100, None), (1, 1, 128, None),
          (300, 9, 512, None), (128, 16, 512, None), (3, 29, 1024, None),
          (17, 2, 256, None), (300, 9, 640, None), (3, 50, 768, None),
          (17, 37, 1000, None), (200, 33, 1024, None)]
CUDNN_H = 1024  # widths whose timed shapes carry cuDNN's call beside them


def cudnn_rows(xw, w_h, reps):
    """cuDNN's LSTM call on the recurrence, TF32 allowed (its default) and
    off: {name: (ms, input GEMM ms)}."""
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        out = {"cudnn": cudnn_lstm_ms(xw, w_h, reps)}
        torch.backends.cudnn.allow_tf32 = False
        out["cudnn_f32"] = cudnn_lstm_ms(xw, w_h, reps)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


def bind_forward(lib):
    lr._bind(lib, "lstm_recurrence_launch", *[lr._PTR] * 5, lr._INT,
             lr._INT, lr._INT, lr._PTR)
    if hasattr(lib, "lstm_recurrence_kernel_for"):
        lr._bind(lib, "lstm_recurrence_kernel_for", lr._INT, lr._INT,
                 restype=lr.ctypes.c_char_p)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_forward_builds: no CUDA device", file=sys.stderr)
        return 2
    sources = {"repo": lr.SOURCES["lstm_recurrence"]}
    for arg in sys.argv[1:]:
        name, path = arg.split("=", 1)
        sources[name] = Path(path)
    libs = build_all(sources, REPO / "ensemble_svs_with_interactions_tpu_torch"
                     / "_build" / "bench_forward_builds", bind_forward)
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for B, T, H, timed in SHAPES:
        xw = torch.randn(B, T, 4 * H, device="cuda", generator=g)
        w_h = torch.randn(H, 4 * H, device="cuda", generator=g) / H ** 0.5
        y_ref, c_ref = lr.lstm_recurrence_reference(xw, w_h, want_c=True)
        y, c, y_only = (torch.empty_like(y_ref) for _ in range(3))
        # enough zeroed barrier counters for any build's plan
        counters = torch.zeros(B, device="cuda", dtype=torch.int32)
        rows = {}
        for name, lib in libs.items():
            def launch(want_c, lib=lib):
                counters.zero_()
                return lib.lstm_recurrence_launch(
                    xw.data_ptr(), w_h.data_ptr(),
                    (y if want_c else y_only).data_ptr(),
                    c.data_ptr() if want_c else None, counters.data_ptr(),
                    B, T, H, stream)

            row = {"build": name, "B": B, "T": T, "H": H,
                   "launch_error": launch(True) or launch(False)}
            if hasattr(lib, "lstm_recurrence_kernel_for"):
                row["kernel"] = lib.lstm_recurrence_kernel_for(B, H).decode()
            if not row["launch_error"]:
                torch.cuda.synchronize()
                row["max_abs_err"] = max((y - y_ref).abs().max().item(),
                                         (c - c_ref).abs().max().item())
                row["h_bitwise_between_modes"] = bool(torch.equal(y, y_only))
                rows[name] = (row, launch)
            else:
                print(json.dumps(row), flush=True)
        library = {}
        if timed is not None:
            names = list(rows)
            reps = 5 if T > 1000 else 20
            yardstick = [cudnn_rows(xw, w_h, reps)] if H == CUDNN_H else []
            for name in names + names[::-1] + names:
                row, launch = rows[name]
                row["want_c"] = timed
                row.setdefault("ms", []).append(
                    device_ms(lambda: launch(timed), reps))
            if yardstick:
                yardstick.append(cudnn_rows(xw, w_h, reps))
                for name in yardstick[0]:
                    library[name] = {
                        "build": name, "B": B, "T": T, "H": H,
                        "tf32": name == "cudnn",
                        "ms": [y[name][0] for y in yardstick],
                        "input_gemm_ms": [y[name][1] for y in yardstick]}
        for row, _ in rows.values():
            print(json.dumps(row), flush=True)
        for row in library.values():
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
