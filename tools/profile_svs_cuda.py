"""Where the time of one flagship ``svs_ensemble`` call of the PyTorch
port goes on the card.

    python3 tools/profile_svs_cuda.py

Builds the flagship engine exactly as ``chip_smoke.py`` does (bench.py's
widths, random weights from the same seed, 4 copies of the 31.2 s
fixture), warms it up, then runs one call under ``torch.profiler`` and
prints one JSON line: wall time, summed device kernel time and its share
of the wall (the device's busy share; one stream, so kernels do not
overlap), the number of device kernels launched, and the kernels with the
most device time.  Needs one CUDA device.
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


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_svs_cuda: no CUDA device", file=sys.stderr)
        return 2
    from ensemble_svs_with_interactions_tpu_torch.io import hts

    engine = cs.build_engine(
        "cuda", cs.random_state_dicts(cs.flagship_phases()[1], cs.SEED))
    labels = [hts.load(cs.FIXTURE) for _ in range(cs.N_TRACKS)]
    spk_ids = list(range(cs.N_TRACKS))
    engine.svs_ensemble([lab.copy() for lab in labels], spk_ids=spk_ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        engine.svs_ensemble([lab.copy() for lab in labels], spk_ids=spk_ids)
        wall_s = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    print(json.dumps({
        "card": cs.card_line(), "wall_s": wall_s,
        "device_kernel_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "device_kernels_launched": sum(e.count for e in kernels),
        "stages": engine.last_stage_times,
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "device_ms": _device_us(e) / 1e3} for e in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
