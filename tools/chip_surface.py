"""Phase ``surface`` of ``chip_smoke.py`` alone, on one card.

    python3 tools/chip_surface.py

Builds the kernels (``chip_smoke.phase_build``), packs the stock
single-track voice with its learned postfilter
(``chip_smoke.single_phases(postfilter=True)``, seeded random weights),
opens it on the card (one warm ``svs()``) and on the CPU, then runs
``chip_smoke.phase_surface``: the example scores through ``load_score``
and ``NEUTRINO``, timed ``svs_streaming`` calls with their launches, depth
1 against 2, the first segments card against CPU, the HTTP server and
``run_svs``, printed as ``chip_smoke.py`` prints it (about 2 minutes with
the build).  Then the launches and the card line.  Exits non-zero without
a CUDA device or when a check fails.
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
        print("chip_surface: no CUDA device", file=sys.stderr)
        return 2
    from ensemble_svs_with_interactions_tpu_torch.io import hts
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    t0 = time.time()
    chip_smoke.phase_build(lr)
    label = hts.load(chip_smoke.FIXTURE)
    glob, phases = chip_smoke.single_phases(postfilter=True)
    with tempfile.TemporaryDirectory() as root:
        model_dir = Path(root) / "voice"
        chip_smoke.pack_phases(model_dir, glob, phases,
                               chip_smoke.random_state_dicts(
                                   phases, chip_smoke.SEED))
        engine = SPSVS(model_dir, device="cuda")
        engine.svs(label.copy())
        cpu = SPSVS(model_dir, device="cpu")
        launches = chip_smoke.phase_surface(lr, engine, cpu, model_dir,
                                            label)
    chip_smoke.emit({"launches": launches, "seconds": time.time() - t0})
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
