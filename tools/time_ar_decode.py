"""Time the free-running AR decode of the port's voices on one card, to
compare two trees of the port in one call.

    python3 tools/time_ar_decode.py [--tree DIR] [--frames N] [--calls K]

Imports the port from ``DIR`` (default: this checkout; a second tree,
such as an unpacked parent commit, goes first on ``sys.path``), builds its
kernels, and builds at their shipped widths with seeded random weights:

* ``npss``: ``configs/acoustic/acoustic_npss_ar_mgcf0bap.yaml`` (the lf0,
  mgc and bap AR decoders step by step, the Sinsy encoders on the
  kernels);
* ``single``: ``configs/acoustic/acoustic_multistream_ar_f0.yaml`` (the
  stock single-track voice: one AR lf0 decoder);
* where the tree's ``chip_smoke.py`` has them, the AR option voices
  ``npss_ar_tacotron`` and ``npss_mdn_ar`` (``chip_smoke.ar_option_netg``).

Each model's ``inference`` runs on one seeded input of N frames (B = 1),
a warm-up then K calls, each timed on the host clock around a CUDA
synchronize, as ``svs()`` times its acoustic stage.  Prints one JSON line
per model (the calls' seconds and their seconds per second of audio at
the 5 ms frame shift), then the card's name and power limit.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
CONFIGS = HERE / "ensemble_svs_with_interactions_tpu" / "configs" / "acoustic"
LF0_STATS = {"in_lf0_min": 5.2, "in_lf0_max": 6.6, "out_lf0_mean": 5.9,
             "out_lf0_scale": 0.25}
FRAME_SHIFT_S = 0.005


def netg(name: str) -> dict:
    """A shipped config's netG, its null lf0 statistics filled."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        load_config,
    )

    def fill(node):
        if isinstance(node, dict):
            return {k: LF0_STATS[k] if k in LF0_STATS and v is None
                    else fill(v) for k, v in node.items()}
        return node

    return fill(json.loads(json.dumps(dict(load_config(CONFIGS / name)
                                           .netG))))


def models(tree: Path) -> dict:
    nets = {"npss": netg("acoustic_npss_ar_mgcf0bap.yaml"),
            "single": netg("acoustic_multistream_ar_f0.yaml")}
    sys.path.insert(0, str(tree))
    import chip_smoke

    for voice in getattr(chip_smoke, "AR_OPTION_VOICES", ()):
        nets[voice] = chip_smoke.ar_option_netg(nets["npss"], voice)
    return nets


def time_model(net: dict, frames: int, calls: int) -> dict:
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
        init_module,
    )

    module = init_module(instantiate(net), seed=0).to("cuda").eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (1, frames, net["in_dim"]))
                         .astype(np.float32)).cuda()
    lengths = torch.tensor([frames], device="cuda")

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = module.inference(x, lengths,
                                   generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        return time.perf_counter() - t0

    call()
    runs = [call() for _ in range(calls)]
    audio_s = frames * FRAME_SHIFT_S
    return {"seconds": runs, "per_audio_s": [r / audio_s for r in runs],
            "frames": frames}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_ar_decode: no CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )

    assert Path(lr.__file__).resolve().is_relative_to(tree), lr.__file__
    lr.build()
    for name, net in models(tree).items():
        print(json.dumps({"tree": str(tree), "model": name,
                          **time_model(net, args.frames, args.calls)}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
