"""Time builds of the forward recurrence library against each other on one
card.

    python3 tools/bench_forward_builds.py [name=path/to/lstm_recurrence.cu ...]

Builds the repository's ``csrc/lstm_recurrence.cu`` (as ``repo``) and every
source given (a variant, or the parent commit's copy unpacked beside the
checkout with its own ``lstm_common.cuh``) with the port's nvcc flags, each
into its own library, and checks each ``lstm_recurrence_launch`` against
the plain loop in both modes (h, and h with c; h bitwise equal between
them) at every shape of ``SHAPES``.  At the serving shapes (B = 4,
T = 6656, h only) and the train step's (B = 64, h and c) it times the
launch by device time from CUDA events, in turns (a, b, ..., b, a, a, b,
...), and prints one JSON line per build and shape, with the kernel the
build's dispatch chose where it exports ``lstm_recurrence_kernel_for``.
Needs one CUDA device.
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

from ensemble_svs_with_interactions_tpu_torch.ops import (  # noqa: E402
    lstm_recurrence as lr,
)

# (B, T, H, timed mode): None is checked only; False times h alone (the
# serving calls), True h and c (the train step's forward)
SHAPES = [(4, 6656, 512, False), (4, 6656, 256, False),
          (64, 256, 512, True), (64, 256, 256, True), (64, 64, 256, True),
          (67, 37, 98, None), (5, 37, 100, None), (1, 1, 128, None),
          (300, 9, 512, None), (128, 16, 512, None), (3, 29, 1024, None),
          (17, 2, 256, None)]


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
        if timed is not None:
            names = list(rows)
            reps = 5 if T > 1000 else 20
            for name in names + names[::-1] + names:
                row, launch = rows[name]
                row["want_c"] = timed
                row.setdefault("ms", []).append(
                    device_ms(lambda: launch(timed), reps))
        for row, _ in rows.values():
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
