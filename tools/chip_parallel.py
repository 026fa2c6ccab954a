"""Phase ``parallel`` of ``chip_smoke.py`` alone, on one card.

    python3 tools/chip_parallel.py

Builds the kernels (``chip_smoke.phase_build``), builds the flagship
engine in memory from its seeded weights (``chip_smoke.build_engine``),
renders the 4-part fixture once to warm it, then runs
``chip_smoke.phase_parallel``: the ensemble under ``set_mesh`` (every
card, and two shards of cuda:0), time-sharded WORLD synthesis over two
shards of cuda:0, the flagship's train step on two gloo ranks sharing the
card against one process, and the multitrack trainer under an NCCL group
of one rank against no group; printed as ``chip_smoke.py`` prints it.
Then the launches and the card line.  Exits non-zero without a CUDA
device or when a check fails.

    python3 tools/chip_parallel.py --tiny-step

first runs the phase's train step on the tiny flagship
(``chip_smoke.parallel_step_held(..., tiny=True, check=False)``) and
prints its readings, the checks not applied, then the phase as above.

    python3 tools/chip_parallel.py --repeatability

runs only the trainer of the phase's second part four times at once on
the card: twice on the card's default algorithms and twice on torch's
deterministic ones, and prints which pairs wrote bitwise equal
checkpoints and metrics.
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
        print("chip_parallel: no CUDA device", file=sys.stderr)
        return 2
    from ensemble_svs_with_interactions_tpu_torch.io import hts
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )

    t0 = time.time()
    chip_smoke.phase_build(lr)
    if "--repeatability" in sys.argv[1:]:
        import tempfile

        with tempfile.TemporaryDirectory() as root:
            files, wall = chip_smoke.parallel_trainers(root, {
                "default_1": (False, False), "default_2": (False, False),
                "deterministic_1": (False, True),
                "deterministic_2": (False, True)})
        chip_smoke.emit({"repeatability": {
            kind: {f: files[f"{kind}_1"][f] == files[f"{kind}_2"][f]
                   for f in ("latest.ckpt", "metrics.jsonl")}
            for kind in ("default", "deterministic")}, "wall_s": wall})
        print(chip_smoke.card_line(), flush=True)
        return 0
    if "--tiny-step" in sys.argv[1:]:
        import tempfile

        with tempfile.TemporaryDirectory() as root:
            chip_smoke.emit({"phase": "parallel_step_tiny",
                             **chip_smoke.parallel_step_held(
                                 lr, root, tiny=True, check=False)})
    weights = chip_smoke.random_state_dicts(chip_smoke.flagship_phases()[1],
                                            chip_smoke.SEED)
    engine = chip_smoke.build_engine("cuda", weights)
    labels = [hts.load(chip_smoke.FIXTURE)
              for _ in range(chip_smoke.N_TRACKS)]
    engine.svs_ensemble([lab.copy() for lab in labels],
                        spk_ids=list(range(chip_smoke.N_TRACKS)))
    launches = chip_smoke.phase_parallel(lr, engine, labels)
    chip_smoke.emit({"launches": launches, "seconds": time.time() - t0})
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
