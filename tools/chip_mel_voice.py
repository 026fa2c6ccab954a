"""Phase ``mel_voice`` of ``chip_smoke.py`` alone, on one card.

    python3 tools/chip_mel_voice.py

Builds the kernels (``chip_smoke.phase_build``) and runs
``chip_smoke.phase_mel_voice`` on the 31.2 s fixture: the mel voice at
its widths served, held against the CPU, trained and its kernels held at
its shapes, each printed as ``chip_smoke.py`` prints it (about 2 minutes
with the build).  Then the launches it counted and the card line.  Exits
non-zero without a CUDA device or when a check fails.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_mel_voice: no CUDA device", file=sys.stderr)
        return 2
    from ensemble_svs_with_interactions_tpu_torch.io import hts
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )

    t0 = time.time()
    chip_smoke.phase_build(lr)
    launches, rows = chip_smoke.phase_mel_voice(
        lr, hts.load(chip_smoke.FIXTURE))
    chip_smoke.emit({"launches": launches, "rows": sorted(rows),
                     "seconds": time.time() - t0})
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
