"""Phase ``ar_options`` of ``chip_smoke.py`` alone, on one card.

    python3 tools/chip_ar_options.py

Builds the kernels (``chip_smoke.phase_build``), runs phase
``recipe_single`` (the corpus, dump, scalers and timing models the NPSS
voices reuse) and then ``chip_smoke.phase_ar_options``: the voices
``npss_ar_tacotron`` and ``npss_mdn_ar`` trained, packed and served
through stages 5-7, their launches checked, a train step and ``svs()``
held card against CPU, each printed as ``chip_smoke.py`` prints it (about
3 minutes with the build).  Then the launches and the card line.  Exits
non-zero without a CUDA device or when a check fails.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ar_options: no CUDA device", file=sys.stderr)
        return 2
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )

    t0 = time.time()
    chip_smoke.phase_build(lr)
    with tempfile.TemporaryDirectory() as root:
        chip_smoke.phase_recipe_single(lr, root)
        launches = chip_smoke.phase_ar_options(lr, root)
    chip_smoke.emit({"launches": launches, "seconds": time.time() - t0})
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
