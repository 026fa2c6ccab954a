"""Where the time of one flagship multitrack train step of the PyTorch port
goes on the card.

    python3 tools/profile_train_cuda.py

Builds the train step exactly as ``chip_smoke.py``'s ``train`` phase does
(bench_train.py's workload: the flagship acoustic model at its verbatim
widths with random weights from the same seed, 64 pairs x 256 frames,
Adam at 1e-3), runs two warm-up steps, then one step under
``torch.profiler`` and prints one JSON line: wall time, summed device
kernel time and its share of the wall (the device's busy share; one
stream, so kernels do not overlap), the number of device kernels
launched, the device time of the port's hand-written LSTM kernels, and
the kernels with the most device time.  Needs one CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from profile_svs_cuda import _device_us  # noqa: E402

HAND_WRITTEN = ("lstm_recurrence_kernel", "lstm_recurrence_small_kernel",
                "lstm_recurrence_group_kernel",
                "lstm_gates_kernel", "lstm_bptt_small_kernel",
                "lstm_gates_mma_kernel",
                "lstm_bptt_group_kernel", "lstm_dwh_kernel",
                "lstm_dwh_reduce_kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train_cuda: no CUDA device", file=sys.stderr)
        return 2
    ac, ss = cs.flagship_acoustic_config(4)
    _, step = cs.build_trainer(ac["netG"], ss,
                               cs.seeded_state_dict(ac["netG"], cs.SEED),
                               "cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             cs.train_batch(cs.TRAIN_B, cs.TRAIN_T, sum(ss)).items()}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for _ in range(2):
        step(batch, cs.TRAIN_WEIGHTS, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step(batch, cs.TRAIN_WEIGHTS, gen)
        wall_s = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:20]
    own = {name: sum(_device_us(e) for e in kernels if name in e.key) / 1e3
           for name in HAND_WRITTEN}
    print(json.dumps({
        "card": cs.card_line(), "B": cs.TRAIN_B, "T": cs.TRAIN_T,
        "wall_s": wall_s, "device_kernel_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "device_kernels_launched": sum(e.count for e in kernels),
        "hand_written_ms": own,
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "device_ms": _device_us(e) / 1e3} for e in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
