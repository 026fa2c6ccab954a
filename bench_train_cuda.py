"""Training benchmark of the PyTorch/CUDA port: ``bench_train.py``'s
float32 and bf16 AMP arms on one NVIDIA GPU.

    python3 bench_train_cuda.py            # float32
    python3 bench_train_cuda.py --amp      # bf16 AMP, as the recipe trains
    python3 bench_train_cuda.py --trainer  # the whole trainer, as above
    python3 bench_train_cuda.py --vocoder  # the recipe's vocoder GAN step

The flagship multitrack acoustic model (``chip_smoke.
flagship_acoustic_config``, ``bench.py``'s widths) with random torch
weights from seed 0, the 64 pairs x 256 frames batch of
``bench_train.py:102-111`` from numpy seed 0, Adam at 1e-3,
``pitch_reg_weight`` 1, clip 1.0; float32, or with ``--amp`` the train
step's ``use_amp=True`` (torch's GEMMs and convolutions in bf16 over
float32 master weights, the hand-written LSTM kernels in float32).  Two
warm-up steps, 5 timed warm steps (host clock around a step that ends in
a host copy of its loss), one step with ``blocked_phase_times=True`` for
the forward / backward / optimizer split, then one step under
``torch.utils.flop_counter.FlopCounterMode`` for the operation count
(``chip_smoke.train_bench``, which ``chip_smoke.py``'s ``train`` and
``train_amp`` phases run too).

Prints ONE JSON line: ``metric: "train_frames_per_sec_flagship_
multitrack"`` with main-track frames/s (B * T over the median step, as
``bench_train.py`` counts them), ``use_amp``, the median and every step's
seconds, the split, the peak device memory, ``flops_per_step``, ``mfu``
and the card's name and power limit.

``flops_per_step`` is what ``FlopCounterMode`` counts of torch's own ops
(matmuls and convolutions, forward and backward) plus the hand-written
LSTM kernels, which it cannot see, counted from the step's LSTM shapes
with ``chip_smoke.py``'s operation counts (``recurrence_ops``,
``gates_ops``, ``bptt_loop_ops``, ``dwh_flops``).  ``mfu`` is that count
per second over the peak that ``peak_convention`` names: the card's dense
float32 peak of 67 TFLOP/s for the float32 arm (TF32 off), its dense bf16
tensor-core peak of 989 TFLOP/s for the AMP arm.

``--trainer`` runs the recipe's acoustic phase through the port's
``train/multitrack_trainer.train_multitrack_model`` instead (``chip_smoke.
run_trainer``: the shipped config and train settings, AMP, TRAINER_EPOCHS
epochs on ``chip_smoke.write_corpus``'s synthetic 3-singer corpus,
TRAINER_CORPUS) and prints ``metric: "trainer_frames_per_sec_flagship_
multitrack"``: the frames trained over the trainer's wall seconds (corpus
writing excluded; initialisation, batch building, dev passes and
checkpoints included), with the seconds in train and dev steps, and,
from the same call, the bare AMP step's frames/s (``train_bench``) under
``bare_step``.  A one-epoch run first warms the process (under
``warmup_run``: what a fresh process pays); the second run is measured.

``--vocoder`` times the recipe's vocoder GAN step instead (``chip_smoke.
vocoder_train_bench``: the shipped ``configs/vocoder/
vocoder_parallel_hn_usfgan.yaml`` verbatim, batch 8 of 64-frame crops at
48 kHz from ``chip_smoke.write_vocoder_corpus``, 2 warm-up and 5 timed
steps by CUDA events) and prints ``metric: "vocoder_train_samples_per_
sec"``: audio samples a second over the median step, beside
``vocoder_train_bound`` (the step's convolution and matmul operations,
forward and backward, at the float32 FMA rate), the peak memory and the
device's busy share in one profiled step.

``--device cpu --tiny`` (narrow widths, B = 2, T = 32, no warm-up step;
with ``--trainer`` a tiny model on a small corpus, no warm-up run; with
``--vocoder`` the tiny hn-uSFGAN of ``chip_smoke.tiny_vocoder_trainings``)
exists for the CPU test only: it reports no device metric.  Without a card, the default device fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke
from bench_cuda import bench_device, card_info
from chip_smoke import TRAIN_B, TRAIN_T, train_bench

METRIC = "train_frames_per_sec_flagship_multitrack"
TRAINER_METRIC = "trainer_frames_per_sec_flagship_multitrack"
VOCODER_METRIC = "vocoder_train_samples_per_sec"
TINY_B, TINY_T = 2, 32
# --trainer --tiny: 2 segments x 3 singers, crops of 32 frames, 4 a batch
TINY_CORPUS = dict(n_train=2, n_dev=1, frames=(40, 64))
TINY_DATA = {"data.segment_length": 32, "data.batch_max_frames": 128}


def run(device: torch.device, tiny: bool, use_amp: bool = False) -> dict:
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )

    B, T = (TINY_B, TINY_T) if tiny else (TRAIN_B, TRAIN_T)
    r, _ = train_bench(lr, device, B, T, tiny=tiny, use_amp=use_amp)
    return {"metric": METRIC, "value": r["frames_per_sec"],
            "unit": "frames/s", **r, "tiny": tiny, **card_info(device)}


def run_trainer(device: torch.device, tiny: bool) -> dict:
    """The recipe's acoustic phase through the trainer, then the bare AMP
    step beside it."""
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import merge

    with tempfile.TemporaryDirectory() as root:
        corpus = chip_smoke.write_corpus(
            Path(root) / "dump",
            **(TINY_CORPUS if tiny else chip_smoke.TRAINER_CORPUS),
            seed=chip_smoke.SEED)
        cfg = chip_smoke.recipe_phase_config(
            "acoustic", corpus, Path(root) / "exp",
            **{"train.nepochs": chip_smoke.TRAINER_EPOCHS,
               **(TINY_DATA if tiny else {})})
        if tiny:
            ac, _ = chip_smoke.flagship_acoustic_config(3, tiny=True)
            cfg = merge(cfg, {"model": ac})
        # a first run warms the process (CUDA context, kernel loads,
        # allocator); the second is measured
        cold = None if tiny else chip_smoke.run_trainer(
            lr, merge(cfg, {"train": {
                "nepochs": 1, "out_dir": str(Path(root) / "warmup")}}),
            True, device=device)
        r = chip_smoke.run_trainer(lr, cfg, True, device=device)
    B, T = (TINY_B, TINY_T) if tiny else (TRAIN_B, TRAIN_T)
    bare, _ = train_bench(lr, device, B, T, tiny=tiny, use_amp=True)
    return {"metric": TRAINER_METRIC, "value": r["frames_per_s"],
            "unit": "frames/s", **r, "epochs": chip_smoke.TRAINER_EPOCHS,
            "use_amp": bool(cfg["train"]["use_amp"]),
            "warmup_run": cold and {"epochs": 1, "wall_s": cold["wall_s"],
                                    "frames_per_s": cold["frames_per_s"]},
            "bare_step": {"frames_per_s": bare["frames_per_sec"],
                          "median_step_sec": bare["median_step_sec"],
                          "geometry": bare["geometry"]},
            "tiny": tiny, **card_info(device)}


def run_vocoder(device: torch.device, tiny: bool) -> dict:
    """The recipe's vocoder GAN step (``chip_smoke.vocoder_train_bench``)
    on a synthetic corpus."""
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        if tiny:
            corpus = chip_smoke.write_vocoder_corpus(root / "in", n=2,
                                                     frames=80)
            cfg = chip_smoke.tiny_vocoder_trainings(
                corpus, root / "exp")["hn_usfgan"]
            r = chip_smoke.vocoder_train_bench(cfg, device, warmup=0,
                                               steps=2)
        else:
            corpus = chip_smoke.write_vocoder_corpus(
                root / "in", **chip_smoke.VOCODER_TRAIN_CORPUS)
            cfg = chip_smoke.vocoder_train_config(corpus, root / "exp")
            r = chip_smoke.vocoder_train_bench(cfg, device)
    return {"metric": VOCODER_METRIC, "value": r["samples_per_sec"],
            "unit": "samples/s", "config": chip_smoke.VOCODER_CONFIG, **r,
            "tiny": tiny, **card_info(device)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="narrow widths, B = 2, T = 64 (CPU test only)")
    p.add_argument("--amp", action="store_true",
                   help="the bf16 AMP arm (use_amp=True)")
    p.add_argument("--trainer", action="store_true",
                   help="the whole trainer (the recipe's acoustic phase)")
    p.add_argument("--vocoder", action="store_true",
                   help="the recipe's vocoder GAN step")
    args = p.parse_args(argv)
    device = bench_device(args.device)
    if args.vocoder:
        out = run_vocoder(device, args.tiny)
    elif args.trainer:
        out = run_trainer(device, args.tiny)
    else:
        out = run(device, args.tiny, args.amp)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
