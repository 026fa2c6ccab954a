"""Phase ``importer`` of ``chip_smoke.py`` alone, on one card.

    python3 tools/chip_importer.py

Builds the kernels (``chip_smoke.phase_build``), then runs
``chip_smoke.phase_importer``: a reference NNSVS pack written in the
published tarballs' layout at full width, converted by
``bin/enunu2nnsvs.convert_nnsvs_pack`` and served by ``SPSVS`` on the card
(the weights bitwise, the launches by width, card against CPU);
``bin/generate.py``; the device MLPG against the host path;
``postfilter_sp.yaml`` and ``vocoder_hifigan.yaml`` at the shipped widths;
``bin/anasyn.py``; printed as ``chip_smoke.py`` prints it.  Then the
launches and the card line.  Exits non-zero without a CUDA device or when
a check fails.
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
        print("chip_importer: no CUDA device", file=sys.stderr)
        return 2
    from ensemble_svs_with_interactions_tpu_torch.io import hts
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )

    t0 = time.time()
    chip_smoke.phase_build(lr)
    launches = chip_smoke.phase_importer(lr, hts.load(chip_smoke.FIXTURE))
    chip_smoke.emit({"launches": launches, "seconds": time.time() - t0})
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
