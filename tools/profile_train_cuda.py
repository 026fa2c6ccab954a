"""Where the time of one flagship multitrack train step of the PyTorch port
goes on the card.

    python3 tools/profile_train_cuda.py [--amp]

Builds the train step exactly as ``chip_smoke.py``'s ``train`` phase does
(bench_train.py's workload: the flagship acoustic model at its verbatim
widths with random weights from the same seed, 64 pairs x 256 frames,
Adam at 1e-3), in float32 or with ``--amp`` in the bf16 AMP arm as phase
``train_amp`` does, runs two warm-up steps, then profiles one step with
``chip_smoke.profile_step`` (the view phase ``train_amp`` prints) and
prints one JSON line: wall time, summed device kernel time and its share
of the wall (the device's busy share; one stream, so kernels do not
overlap), the number of device kernels launched, the device time of the
port's hand-written LSTM kernels, any other recurrence kernel, and the
kernels with the most device time.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--amp", action="store_true",
                        help="profile the bf16 AMP arm")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_train_cuda: no CUDA device", file=sys.stderr)
        return 2
    ac, ss = cs.flagship_acoustic_config(4)
    _, step = cs.build_trainer(ac["netG"], ss,
                               cs.seeded_state_dict(ac["netG"], cs.SEED),
                               "cuda", use_amp=args.amp)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             cs.train_batch(cs.TRAIN_B, cs.TRAIN_T, sum(ss)).items()}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for _ in range(2):
        step(batch, cs.TRAIN_WEIGHTS, gen)
    view = cs.profile_step(lambda: step(batch, cs.TRAIN_WEIGHTS, gen))
    print(json.dumps({"card": cs.card_line(), "B": cs.TRAIN_B,
                      "T": cs.TRAIN_T, "use_amp": args.amp, **view}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
