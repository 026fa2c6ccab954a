"""Training benchmark of the PyTorch/CUDA port: ``bench_train.py``'s
default arm on one NVIDIA GPU.

    python3 bench_train_cuda.py

The flagship multitrack acoustic model (``chip_smoke.
flagship_acoustic_config``, ``bench.py``'s widths) with random torch
weights from seed 0, the 64 pairs x 256 frames batch of
``bench_train.py:102-111`` from numpy seed 0, Adam at 1e-3,
``pitch_reg_weight`` 1, clip 1.0, float32.  Two warm-up steps, 5 timed
warm steps (host clock around a step that ends in a host copy of its
loss), one step with ``blocked_phase_times=True`` for the forward /
backward / optimizer split, then one step under
``torch.utils.flop_counter.FlopCounterMode`` for the operation count.

Prints ONE JSON line: ``metric: "train_frames_per_sec_flagship_
multitrack"`` with main-track frames/s (B * T over the median step, as
``bench_train.py`` counts them), the median and every step's seconds, the
split, the peak device memory, ``flops_per_step``, ``mfu`` and the card's
name and power limit.

``flops_per_step`` is what ``FlopCounterMode`` counts of torch's own ops
(matmuls and convolutions, forward and backward) plus the hand-written
LSTM kernels, which it cannot see, counted from the step's LSTM shapes
with ``chip_smoke.py``'s operation counts (``recurrence_ops``,
``gates_ops``, ``bptt_loop_ops``, ``dwh_flops``).  ``mfu`` is that count
per second over the card's dense float32 peak of 67 TFLOP/s (the port runs
float32 with TF32 off).

``--amp`` raises ``NotImplementedError``: the bf16 arm is not ported.
``--device cpu --tiny`` (narrow widths, B = 2, T = 64) exists for the CPU
test only: it reports no device metric.  Without a card, the default
device fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import chip_smoke
from bench_cuda import bench_device, card_info, sync
from chip_smoke import PEAK_FP32_FLOP_PER_S, SEED, TRAIN_B, TRAIN_T

METRIC = "train_frames_per_sec_flagship_multitrack"
WARMUP_STEPS = 2
TIMED_STEPS = 5
TINY_B, TINY_T = 2, 64
COUNTERS = ("lstm_recurrence", "lstm_bptt", "lstm_dwh")


def train_lstm_shapes(netg, T: int) -> dict:
    """{(H, sequence length): single-direction LSTM runs per train step} of
    the multitrack acoustic model: each of the two track passes (main and
    sub) runs the encoder's and the decoders' (bi)LSTM layers over T frames
    and the AR lf0 decoder's cell over T / reduction_factor."""
    enc, lf0 = netg["encoder"], netg["lf0_model"]
    runs = {}

    def add(H, t, n):
        runs[(H, t)] = runs.get((H, t), 0) + 2 * n

    add(enc["hidden_dim"], T,
        enc["num_layers"] * (2 if enc["bidirectional"] else 1))
    add(lf0["lstm_hidden_dim"], T, lf0["num_lstm_layers"] * 2)
    add(lf0["decoder_hidden_dim"], T // lf0["reduction_factor"],
        lf0["decoder_layers"])
    for name in ("mgc_model", "vuv_model", "bap_model"):
        dec = netg[name]
        add(dec["lstm_hidden_dim"], T,
            dec["num_lstm_layers"] * (2 if dec["bidirectional"] else 1))
    return runs


def lstm_kernel_flops(shapes: dict, B: int) -> int:
    """Operations of the hand-written LSTM kernels in one train step: per
    run the forward recurrence, the BPTT's gate pre-pass and reverse loop,
    and dW_h."""
    return sum(n * (chip_smoke.recurrence_ops(B, T, H)
                    + chip_smoke.gates_ops(B, T, H)
                    + chip_smoke.bptt_loop_ops(B, T, H)
                    + chip_smoke.dwh_flops(B, T, H))
               for (H, T), n in shapes.items())


def run(device: torch.device, tiny: bool) -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )

    ac, ss = chip_smoke.flagship_acoustic_config(4, tiny=tiny)
    B, T = (TINY_B, TINY_T) if tiny else (TRAIN_B, TRAIN_T)
    _, step = chip_smoke.build_trainer(
        ac["netG"], ss, chip_smoke.seeded_state_dict(ac["netG"], SEED),
        device)
    batch = {k: torch.as_tensor(v, device=device) for k, v in
             chip_smoke.train_batch(B, T, sum(ss)).items()}
    gen = torch.Generator(device=device).manual_seed(SEED)
    weights = chip_smoke.TRAIN_WEIGHTS
    losses = [step(batch, weights, gen)["Loss"] for _ in range(WARMUP_STEPS)]

    for name in COUNTERS:
        getattr(lr, name).launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step_s = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(step(batch, weights, gen)["Loss"])
        step_s.append(time.perf_counter() - t0)
    launches = {n: getattr(lr, n).launches / TIMED_STEPS for n in COUNTERS}
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    losses.append(step(batch, weights, gen, blocked_phase_times=True)["Loss"])
    split = dict(step.last_phase_times)

    counter = FlopCounterMode(display=False)
    with counter:
        losses.append(step(batch, weights, gen)["Loss"])
    sync(device)
    torch_flops = counter.get_total_flops()
    shapes = train_lstm_shapes(ac["netG"], T)
    kernel_flops = lstm_kernel_flops(shapes, B)
    flops = torch_flops + kernel_flops

    median = float(np.median(step_s))
    on_card = device.type == "cuda"
    return {
        "metric": METRIC, "value": B * T / median, "unit": "frames/s",
        "frames_per_sec": B * T / median, "median_step_sec": median,
        "all_step_sec": step_s, "steps": TIMED_STEPS,
        "warmup_steps": WARMUP_STEPS, "batch_pairs": B, "frames": T,
        "frames_per_batch": B * T, "geometry": f"{B}x{T}",
        "split_sec": split, "peak_mem_gib": peak,
        "flops_per_step": flops, "flops_torch_ops": torch_flops,
        "flops_lstm_kernels": kernel_flops,
        "lstm_runs_per_step": {f"H={H} T={t}": n
                               for (H, t), n in shapes.items()},
        "flops_convention": (
            "torch ops as torch.utils.flop_counter.FlopCounterMode counts "
            "them (matmuls and convolutions, forward and backward) plus the "
            "hand-written LSTM kernels it cannot see, per run the forward, "
            "the BPTT pre-pass and loop and dW_h as chip_smoke.py's "
            "recurrence_ops, gates_ops, bptt_loop_ops and dwh_flops count "
            "them (multiply-adds as 2, plus their elementwise operations)"),
        "tflops_per_sec": flops / median / 1e12 if on_card else None,
        "mfu": flops / median / PEAK_FP32_FLOP_PER_S if on_card else None,
        "mfu_convention": (
            "flops_per_step / median_step_sec / 67e12: the H100 SXM dense "
            "float32 peak outside the tensor cores (NVIDIA data sheet, "
            "700 W); the port computes in float32 with TF32 off"),
        "launches_per_step": launches, "losses": losses,
        "final_loss": losses[-1], "use_amp": False, "optimizer": "Adam 1e-3",
        "tiny": tiny, **card_info(device),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="narrow widths, B = 2, T = 64 (CPU test only)")
    p.add_argument("--amp", action="store_true",
                   help="bf16 forward/backward: not ported, raises")
    args = p.parse_args(argv)
    if args.amp:
        raise NotImplementedError(
            "--amp: the bf16 arm of the train step (the JAX package's "
            "train/multitrack.py use_amp) is not ported")
    print(json.dumps(run(bench_device(args.device), args.tiny)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
