"""The multitrack trainer (timelag, duration and acoustic models), as
``ensemble_svs_with_interactions_tpu/train/multitrack_trainer.py`` runs it:
paired feature dumps, epochs of length-bucketed batches (random crops of
one window across both tracks for the acoustic model), a dev pass each
epoch with objective distortions, ``latest`` / ``best_loss`` /
``epoch%04d`` checkpoints, ``metrics.jsonl`` and ``dev_metrics.json``.

It runs on ``device="cuda"`` unless the caller passes ``"cpu"``; with
``distributed.coordinator`` set it is one rank of a data-parallel run
(``trainer.join_group``, ``parallel/mesh.py``): every rank builds the same
global batches and trains on its rows, and rank 0 writes.  Batches are built on a prefetch thread, which pins them on the
card's host; the copy to the card is issued on the training thread with
``non_blocking=True``.  The steps return their metrics as floats (one
device-to-host copy a step); the trainer reads nothing else from the card
but the dev predictions it scores.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch

from ensemble_svs_with_interactions_tpu_torch.data.multitrack import (
    MultiTrackBatchIterator,
    MultiTrackFeatsDataset,
)
from ensemble_svs_with_interactions_tpu_torch.parallel.mesh import (
    all_gather_rows,
    replicate_tree,
)
from ensemble_svs_with_interactions_tpu_torch.train.loop import (
    TrainState,
    build_optimizer,
    load_params_shape_filtered,
)
from ensemble_svs_with_interactions_tpu_torch.train.multitrack import (
    _stream_to_point,
    create_multitrack_acoustic_train_step,
    create_multitrack_timing_train_step,
    interaction_weight,
)
from ensemble_svs_with_interactions_tpu_torch.train.trainer import (
    dev_distortions,
    join_group,
    load_out_scaler,
    pitch_reg_weights,
    run_epochs,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    Config,
    instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_variables,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from ensemble_svs_with_interactions_tpu_torch.utils.logger import getLogger
from ensemble_svs_with_interactions_tpu_torch.utils.misc import init_seed


def train_multitrack_model(config: Config, is_acoustic: bool,
                           device="cuda", observe=None) -> Dict[str, float]:
    """Train a multitrack timelag/duration (``is_acoustic=False``, note-
    merged pairs) or acoustic model (frame-synced pairs) from a config tree
    with the JAX trainer's keys; returns the last epoch's dev metrics.
    ``observe`` sees each batch (``trainer.run_epochs``)."""
    logger = getLogger(verbose=config.get("verbose", 1), name="train_mt")
    seed = int(config.get("seed", 1234))
    init_seed(seed)
    device, mesh = join_group(config, device)

    module = instantiate(config.model.netG)
    # the flax twin's schemes, drawn at seed 0 as JAX's module.init
    variables = init_variables(module, seed=0)
    resume_path = config.get_path("train.resume.checkpoint")
    if resume_path:
        variables, copied = load_params_shape_filtered(resume_path, variables)
        logger.info("warm-started %d tensors from %s", copied, resume_path)
    flax_to_torch(module, variables)
    module.to(device)
    replicate_tree(module.state_dict(), mesh)  # every rank starts as rank 0

    spk_names = list(config.data.get("spk_names", []) or [])
    datasets = {}
    for split in ("train_no_dev", "dev"):
        d = config.data[split]
        datasets[split] = MultiTrackFeatsDataset(
            d["in_dir"], d["out_dir"], spk_names,
            max_frames=int(config.data.get("filter_num_frames", 6000)),
            load_times=not is_acoustic)
        logger.info("%s: %d track pairs", split, len(datasets[split]))

    sync = "frames" if is_acoustic else "notes"
    batch_max_frames = int(config.data.get("batch_max_frames", 32000))
    # epoch-quantized schedules tick per epoch in the reference; their
    # transition counts scale by the planned batches per epoch (planned
    # without the world size's batch multiple, as the JAX trainer plans)
    steps_per_epoch = max(len(MultiTrackBatchIterator(
        datasets["train_no_dev"], sync=sync, max_tokens=batch_max_frames,
        shuffle=False, seed=0)), 1)
    optimizer, scheduler = build_optimizer(
        module.parameters(), dict(config.train.optim.optimizer),
        dict(config.train.optim.get("lr_scheduler", {}) or {}),
        steps_per_epoch=steps_per_epoch,
        accum_steps=int(config.train.optim.get("accum_steps", 1)))

    clip_norm = float(config.train.optim.get("clip_norm", 1.0))
    use_amp = bool(config.train.get("use_amp", False))
    pitch_reg_weight = float(config.train.get("pitch_reg_weight", 1.0))
    if is_acoustic:
        train_step, eval_step = create_multitrack_acoustic_train_step(
            module, optimizer, dict(config.model), scheduler=scheduler,
            clip_norm=clip_norm,
            feats_criterion=config.train.get("feats_criterion", "mse"),
            pitch_reg_weight=pitch_reg_weight,
            sub_require_grad=bool(config.train.get("sub_require_grad", True)),
            use_amp=use_amp, device=device)
    else:
        train_step, eval_step = create_multitrack_timing_train_step(
            module, optimizer, scheduler=scheduler, clip_norm=clip_norm,
            use_amp=use_amp, device=device)

    out_scaler = None
    prefix = config.data.get("out_scaler_prefix")
    if prefix and is_acoustic:
        out_scaler = load_out_scaler(prefix)

    out_dir = Path(config.train.out_dir)
    nepochs = int(config.train.get("nepochs", 10))
    generator = torch.Generator(device=device).manual_seed(seed)
    steps = [0]
    pitch_reg = (pitch_reg_weights(config, "in_feats0")
                 if is_acoustic and pitch_reg_weight > 0 else None)
    reduction = (int(config.model.netG.get("reduction_factor", 1))
                 if is_acoustic else 1)
    time_multiple = max(int(config.data.get("time_multiple", 32)), reduction)
    # time padding must stay divisible by the AR reduction factor
    while time_multiple % reduction != 0:
        time_multiple += 1
    use_random_segments = bool(config.data.get("use_random_segments", False))
    segment_length = int(config.data.get("segment_length", 256))
    segment_length = -(-segment_length // time_multiple) * time_multiple
    stream_sizes = list(config.model.get("stream_sizes", []))

    def batches(split, epoch):
        train = split == "train_no_dev"
        return MultiTrackBatchIterator(
            datasets[split], sync=sync, max_tokens=batch_max_frames,
            time_multiple=time_multiple, batch_multiple=mesh.world_size,
            shuffle=train,
            seed=epoch,
            length_cap=(segment_length if (train and is_acoustic
                                           and use_random_segments)
                        else None))

    def run_batch(b, batch, train, epoch, first, writer):
        if not is_acoustic:
            if not train:
                return eval_step(b), None
            steps[0] += 1
            return train_step(b, generator), None
        weights = {name: interaction_weight(
            config.train.get(f"{name}_weight", 1.0), epoch, nepochs)
            for name in ("logf0_diff", "mgc_diff")}
        if train:
            steps[0] += 1
            return train_step(b, weights, generator), None
        metrics, pred_main = eval_step(b, weights)
        if isinstance(pred_main, (tuple, list)):  # MDN streams -> mu
            pred_main = torch.cat([_stream_to_point(p) for p in pred_main],
                                  dim=-1)
        pred_main = all_gather_rows(pred_main)
        if (out_scaler is not None
                and pred_main.shape[-1] == sum(stream_sizes)):
            metrics.update(dev_distortions(
                config, out_dir, epoch, pred_main, batch["out_feats0"],
                batch["lengths"], out_scaler, writer, first))
        return metrics, pred_main

    return run_epochs(config, out_dir, logger, device, batches, pitch_reg,
                      run_batch, lambda: TrainState.capture(
                          module, optimizer, scheduler, steps[0]), observe,
                      mesh)
