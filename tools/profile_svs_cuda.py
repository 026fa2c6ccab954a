"""Where the time of one flagship ``svs_ensemble`` call of the PyTorch
port goes on the card, or of one single-track ``svs`` call.

    python3 tools/profile_svs_cuda.py [--single-track | --diffusion |
                                       --vocoder usfgan]

Builds the flagship engine exactly as ``chip_smoke.py`` does (bench.py's
widths, random weights from the same seed, 4 copies of the 31.2 s
fixture) or, with ``--single-track``, the stock single-track voice of
``chip_smoke.single_phases`` (one copy through ``svs``), or, with
``--diffusion``, the recipe's diffusion voice of
``chip_smoke.diffusion_phases`` (the same 4 copies, speakers
``DIFFUSION_SPK_IDS``), or, with ``--vocoder usfgan``, the flagship with
the recipe's neural vocoder (``chip_smoke.with_vocoder``, rendering with
``vocoder_type="usfgan"``), warms it up,
then runs one call under ``torch.profiler`` and
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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_svs_cuda: no CUDA device", file=sys.stderr)
        return 2
    from ensemble_svs_with_interactions_tpu_torch.io import hts

    argv = sys.argv[1:]
    single = "--single-track" in argv
    diffusion = "--diffusion" in argv
    vocoder = (argv[argv.index("--vocoder") + 1] if "--vocoder" in argv
               else "world")
    if vocoder not in ("world", "usfgan"):
        print(f"profile_svs_cuda: unknown vocoder {vocoder!r}",
              file=sys.stderr)
        return 2
    voice = (cs.single_phases() if single else cs.diffusion_phases()
             if diffusion else cs.flagship_phases())
    if vocoder != "world":
        voice = cs.with_vocoder(voice)
    spk_ids = (cs.DIFFUSION_SPK_IDS if diffusion
               else list(range(cs.N_TRACKS)))
    engine = cs.build_engine(
        "cuda", cs.random_state_dicts(voice[1], cs.SEED), voice)
    labels = [hts.load(cs.FIXTURE) for _ in range(cs.N_TRACKS)]

    def call():
        if single:
            return engine.svs(labels[0].copy(), vocoder_type=vocoder)
        return engine.svs_ensemble([lab.copy() for lab in labels],
                                   vocoder_type=vocoder, spk_ids=spk_ids)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        call()
        wall_s = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and cs.device_us(e) > 0]
    busy_us = sum(cs.device_us(e) for e in kernels)
    top = sorted(kernels, key=cs.device_us, reverse=True)[:15]
    print(json.dumps({
        "card": cs.card_line(),
        "call": "svs" if single else "svs_ensemble",
        "voice": ("single" if single else "diffusion" if diffusion
                  else "flagship"), "vocoder": vocoder, "wall_s": wall_s,
        "device_kernel_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "device_kernels_launched": sum(e.count for e in kernels),
        "stages": engine.last_stage_times,
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "device_ms": cs.device_us(e) / 1e3} for e in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
