"""The single-track trainer (timelag, duration and acoustic models), as
``ensemble_svs_with_interactions_tpu/train/trainer.py`` runs it, and the
parts both trainers share: the host-side batch pipeline (pitch
regularization weights, pinning, the copy to the card), the dev pass's
distortions and renders, the metrics writer from a config, and the
data-parallel set-up (``join_group``).

``train_model`` reads ``*-feats.npy`` dumps (with speaker ids from the
file names when ``data.spk_names`` is set), trains on length-bucketed
batches (random crops with ``use_random_segments``), runs a dev pass each
epoch and writes ``latest`` / ``best_loss`` / ``epoch%04d`` checkpoints,
``metrics.jsonl`` and ``dev_metrics.json``, on ``device="cuda"`` unless
the caller passes ``"cpu"``.  With ``distributed.coordinator`` set it is
one rank of a data-parallel run (``parallel/mesh.py``).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ensemble_svs_with_interactions_tpu_torch.base import PredictionType
from ensemble_svs_with_interactions_tpu_torch.data.dataset import (
    BucketedBatchIterator,
    FeatsDataset,
    MultiSpeakerFeatsDataset,
    prefetch_batches,
)
from ensemble_svs_with_interactions_tpu_torch.parallel.mesh import (
    all_gather_rows,
    barrier,
    batch_sharding,
    drawing_rows,
    make_mesh,
    maybe_initialize_distributed,
    rank,
    replicate_tree,
)
from ensemble_svs_with_interactions_tpu_torch.train import losses as L
from ensemble_svs_with_interactions_tpu_torch.train import metrics as M
from ensemble_svs_with_interactions_tpu_torch.train.loop import (
    MetricsWriter,
    TrainState,
    build_optimizer,
    create_train_step,
    load_params_shape_filtered,
    save_checkpoint,
    write_dev_metrics,
)
from ensemble_svs_with_interactions_tpu_torch.train.losses import (
    compute_pitch_regularization_weight,
)
from ensemble_svs_with_interactions_tpu_torch.train.multitrack import (
    _stream_to_point,
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
from ensemble_svs_with_interactions_tpu_torch.utils.profiling import (
    enable_detect_anomaly,
)
from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
    StandardScaler,
)


def load_out_scaler(path_prefix) -> StandardScaler:
    return StandardScaler(np.load(f"{path_prefix}_mean.npy"),
                          np.load(f"{path_prefix}_var.npy"),
                          np.load(f"{path_prefix}_scale.npy"))


def join_group(config: Config, device):
    """The data-parallel set-up both trainers share, as the JAX trainers'
    head: join the process group of ``config.distributed``
    (``coordinator`` "host:port", ``num_processes``, ``process_id``, which
    default to torchrun's ``WORLD_SIZE`` / ``RANK``; no coordinator: one
    process), then turn on ``train.use_detect_anomaly``.  Returns (this rank's device, its
    one-device mesh: ``mesh.world_size`` ranks split each global batch)."""
    dist_cfg = dict(config.get("distributed", None) or {})
    maybe_initialize_distributed(
        dist_cfg.get("coordinator"), dist_cfg.get("num_processes"),
        dist_cfg.get("process_id"), device=device)
    if config.train.get("use_detect_anomaly", False):
        enable_detect_anomaly()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device, make_mesh(device=[device])


def rows_of(mesh, batch):
    """Under a process group, the context in which this rank's random
    draws are the global batch's, cut to its rows
    (``parallel.mesh.drawing_rows``); else a no-op."""
    if mesh is None or mesh.world_size == 1:
        return contextlib.nullcontext()
    rows = len(batch["lengths"])
    (_, sl), = batch_sharding(mesh, rows)
    return drawing_rows(sl, rows)


class NoWriter:
    """The metrics writer of a rank that writes nothing (all but rank 0)."""

    tb = mlflow = None

    def log(self, step, metrics, prefix=""):
        pass

    def close(self):
        pass


def metrics_writer(config: Config, out_dir) -> MetricsWriter:
    mlflow = config.get("mlflow", None) or {}
    use_mlflow = bool(config.train.get("use_mlflow", False))
    return MetricsWriter(
        out_dir,
        use_tensorboard=config.train.get("use_tensorboard", False),
        use_mlflow=use_mlflow,
        mlflow_experiment=str(mlflow.get("experiment", "default")),
        mlflow_run_name=mlflow.get("run_name", None),
        mlflow_params=dict(config.model) if use_mlflow else None)


def pitch_reg_weights(config: Config, key: str):
    """The per-batch pitch-regularization weights from the denormalized
    score lf0 of ``batch[key]`` (zero on padded and rest frames, so notes
    segment), or None where ``data.in_lf0_idx`` is not set."""
    lf0_idx = int(config.data.get("in_lf0_idx", -1))
    if lf0_idx < 0:
        return None
    lf0_min = float(config.data.get("in_lf0_min", 0.0))
    lf0_max = float(config.data.get("in_lf0_max", 1.0))
    rest_idx = int(config.data.get("in_rest_idx", 0))
    decay_size = int(config.train.get("pitch_reg_decay_size", 25))

    def weights(batch):
        x = batch[key]
        lf0_denorm = x[:, :, lf0_idx] * (lf0_max - lf0_min) + lf0_min
        valid = np.arange(x.shape[1])[None, :] < batch["lengths"][:, None]
        if rest_idx >= 0:
            valid = valid & (x[:, :, rest_idx] <= 0)
        return compute_pitch_regularization_weight(
            np.where(valid, lf0_denorm, 0.0), decay_size)

    return weights


def pin_batch(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of arrays as CPU tensors, pinned when ``device`` is a card
    (run on the prefetch thread)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in batch.items()}
    if torch.device(device).type == "cuda":
        out = {k: v.pin_memory() for k, v in out.items()}
    return out


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    """The copies to ``device``, issued without waiting (run on the
    training thread, in its stream order)."""
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def dev_distortions(config: Config, out_dir, epoch: int, pred, out_feats,
                    lengths, out_scaler, writer, render: bool):
    """A dev batch's objective distortions (``ObjEval_*``) and, with
    ``render`` (the epoch's first dev batch) and ``train.eval_render``,
    its renders."""
    pred = pred.detach().float().cpu().numpy()
    model = config.model
    args = (out_scaler, list(model.stream_sizes),
            list(model.has_dynamic_features), int(model.num_windows))
    if render and config.train.get("eval_render", False) and rank() == 0:
        from ensemble_svs_with_interactions_tpu_torch.train.eval_render import (  # noqa: E501
            render_eval_outputs,
        )

        render_eval_outputs(out_dir, epoch, pred, out_feats, lengths, *args,
                            int(config.data.get("sample_rate", 48000)),
                            writer=writer)
    return M.compute_distortions(pred, out_feats, lengths, *args)


def run_epochs(config: Config, out_dir, logger, device, batches, pitch_reg,
               run_batch, capture, observe=None,
               mesh=None) -> Dict[str, float]:
    """The loop both trainers share: for each of ``train.nepochs`` epochs
    the training split, then the dev split, ``batches(split, epoch)``
    built on the prefetch thread (with ``pitch_reg(batch)`` added as
    ``pitch_reg_dyn_ws`` when given) and pinned there;
    ``run_batch(tensors, arrays, train, epoch, first, writer)`` runs one
    and returns its metrics as floats and the dev pass's point prediction
    (None in training).  Each split's means go to ``metrics.jsonl``; after
    each dev pass ``capture()`` is checkpointed (``best_loss`` when the
    dev ``Loss`` is the lowest so far); at the end ``dev_metrics.json``.
    Returns the last dev means.

    ``observe(split, seconds, arrays, pred)``, where given, sees each
    batch after it ran: the host seconds of its copy to the device and its
    step (each step ends in a host copy of its metrics, so these are the
    device's seconds too, without the wait for the prefetch thread), its
    host arrays and the prediction.

    Under a process group (``mesh.world_size`` ranks) each global batch
    (every rank builds the same one, ``batches`` padding it to a multiple
    of the world size) is cut to this rank's rows before it is pinned;
    ``run_batch`` gets those rows as tensors and the global batch as
    arrays, draws the global batch's random masks cut to its rows
    (``rows_of``: every rank's generator takes the same seed, so the run
    draws what one process draws), and returns global metrics and the
    global prediction.  Only
    rank 0 writes the metrics, checkpoints and ``dev_metrics.json``; the
    others wait for each checkpoint at a barrier."""
    lead = mesh is None or mesh.rank == 0
    writer = metrics_writer(config, out_dir) if lead else NoWriter()
    nepochs = int(config.train.get("nepochs", 10))
    best_dev, best_epoch = float("inf"), 0
    best_metrics: Dict[str, float] = {}
    last_metrics: Dict[str, float] = {}
    for epoch in range(1, nepochs + 1):
        for split in ("train_no_dev", "dev"):
            train = split == "train_no_dev"

            def host_pipeline(it=batches(split, epoch)):
                for batch in it:
                    if pitch_reg is not None:
                        batch["pitch_reg_dyn_ws"] = pitch_reg(batch)
                    rows = batch
                    if mesh is not None:
                        (_, sl), = batch_sharding(mesh, len(batch["lengths"]))
                        rows = {k: v[sl] for k, v in batch.items()}
                    yield batch, pin_batch(rows, device)

            epoch_metrics: Dict[str, list] = {}
            for i, (batch, pinned) in enumerate(
                    prefetch_batches(host_pipeline())):
                t0 = time.perf_counter()
                with rows_of(mesh, batch):
                    metrics, pred = run_batch(to_device(pinned, device),
                                              batch, train, epoch, i == 0,
                                              writer)
                if observe is not None:
                    observe(split, time.perf_counter() - t0, batch, pred)
                for k, v in metrics.items():
                    epoch_metrics.setdefault(k, []).append(v)
            means = {k: float(np.mean(v)) for k, v in epoch_metrics.items()}
            writer.log(epoch, means, prefix=f"{split}/")
            logger.info("epoch %d [%s] %s", epoch, split,
                        {k: round(v, 4) for k, v in means.items()})
            if not train:
                dev_loss = means.get("Loss", float("inf"))
                is_best = dev_loss < best_dev
                best_dev = min(best_dev, dev_loss)
                if is_best:
                    best_epoch, best_metrics = epoch, means
                if lead:
                    save_checkpoint(out_dir, capture(), epoch,
                                    is_best=is_best,
                                    save_interval=int(config.train.get(
                                        "checkpoint_interval", 0)))
                barrier()
                last_metrics = means
    writer.close()
    if lead:
        write_dev_metrics(out_dir, best_epoch, best_metrics, last_metrics)
    barrier()
    return last_metrics


def _point(module, pred_out, stream_sizes):
    """The dev prediction reduced to a point estimate (MDN mu) for the
    distortions; a refinement list scores its last stage.  A bare
    diffusion or flow-matching decoder's (drawn target, prediction) pair
    has none: None."""
    if module.prediction_type() == PredictionType.DIFFUSION:
        return None
    if L.is_refinement_list(pred_out, stream_sizes):
        pred_out = pred_out[-1]
    if not isinstance(pred_out, (tuple, list)):
        return pred_out
    if module.prediction_type() == PredictionType.MULTISTREAM_HYBRID:
        return torch.cat([_stream_to_point(p) for p in pred_out], dim=-1)
    return _stream_to_point(tuple(pred_out))


def train_model(config: Config, is_acoustic: bool = False,
                device="cuda", observe=None) -> Dict[str, float]:
    """Train a single-track model from a config tree with the JAX trainer's
    keys (``data.train_no_dev`` / ``data.dev`` ``{in_dir, out_dir}``,
    ``data.batch_max_frames``, ``model.netG``, ``train.optim``,
    ``train.nepochs``, ``train.out_dir``, ...); returns the last epoch's
    dev metrics.  ``observe`` sees each batch (``run_epochs``)."""
    logger = getLogger(verbose=config.get("verbose", 1), name="train")
    seed = int(config.get("seed", 1234))
    init_seed(seed)
    device, mesh = join_group(config, device)

    module = instantiate(config.model.netG)
    # the flax twin's schemes, drawn at seed 0 as JAX's module.init
    variables = init_variables(module, seed=0)
    out_dir = Path(config.train.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    resume_path = config.get_path("train.resume.checkpoint")
    if resume_path:
        variables, copied = load_params_shape_filtered(resume_path, variables)
        logger.info("warm-started %d tensors from %s", copied, resume_path)
    flax_to_torch(module, variables)
    module.to(device)
    replicate_tree(module.state_dict(), mesh)  # every rank starts as rank 0

    max_frames = int(config.data.get("filter_num_frames", 6000))
    batch_max_frames = int(config.data.get("batch_max_frames", 32000))
    time_multiple = int(config.data.get("time_multiple", 32))
    spk_names = list(config.data.get("spk_names", []) or [])
    datasets = {}
    for split in ("train_no_dev", "dev"):
        d = config.data[split]
        if spk_names:
            datasets[split] = MultiSpeakerFeatsDataset(
                d["in_dir"], d["out_dir"], spk_names, max_frames=max_frames)
        else:
            datasets[split] = FeatsDataset(d["in_dir"], d["out_dir"],
                                           max_frames=max_frames)
        logger.info("%s: %d utterances", split, len(datasets[split]))

    # epoch-quantized schedules tick per epoch in the reference; their
    # transition counts scale by the planned batches per epoch
    steps_per_epoch = max(len(BucketedBatchIterator(
        datasets["train_no_dev"], max_tokens=batch_max_frames,
        time_multiple=time_multiple, batch_multiple=mesh.world_size,
        shuffle=False, seed=0)), 1)
    optimizer, scheduler = build_optimizer(
        module.parameters(), dict(config.train.optim.optimizer),
        dict(config.train.optim.get("lr_scheduler", {}) or {}),
        steps_per_epoch=steps_per_epoch,
        accum_steps=int(config.train.optim.get("accum_steps", 1)))

    pitch_reg_weight = (float(config.train.get("pitch_reg_weight", 1.0))
                        if is_acoustic else 0.0)
    train_step, eval_step = create_train_step(
        module, optimizer, dict(config.model), scheduler=scheduler,
        clip_norm=float(config.train.optim.get("clip_norm", 1.0)),
        feats_criterion=config.train.get("feats_criterion", "mse"),
        pitch_reg_weight=pitch_reg_weight,
        stream_wise_loss=bool(config.train.get("stream_wise_loss", False)),
        stream_weights=config.train.get("stream_weights"),
        use_amp=bool(config.train.get("use_amp", False)), device=device)

    out_scaler = None
    if config.data.get("out_scaler_prefix"):
        out_scaler = load_out_scaler(config.data.out_scaler_prefix)
    pitch_reg = (pitch_reg_weights(config, "in_feats")
                 if is_acoustic and pitch_reg_weight > 0 else None)
    use_random_segments = bool(config.data.get("use_random_segments", False))
    segment_length = int(config.data.get("segment_length", 256))
    segment_length = -(-segment_length // time_multiple) * time_multiple
    stream_sizes = list(config.model.get("stream_sizes", []))
    generator = torch.Generator(device=device).manual_seed(seed)
    steps = [0]

    def batches(split, epoch):
        train = split == "train_no_dev"
        return BucketedBatchIterator(
            datasets[split], max_tokens=batch_max_frames,
            time_multiple=time_multiple, batch_multiple=mesh.world_size,
            shuffle=train, seed=epoch,
            length_cap=(segment_length if (train and use_random_segments)
                        else None))

    def run_batch(b, batch, train, epoch, first, writer):
        if train:
            steps[0] += 1
            return train_step(b, generator), None
        metrics, pred_out = eval_step(b)
        pred = _point(module, pred_out, stream_sizes)
        if pred is not None:
            pred = all_gather_rows(pred)
        if (is_acoustic and out_scaler is not None and pred is not None
                and pred.shape[-1] == sum(stream_sizes)):
            metrics.update(dev_distortions(
                config, out_dir, epoch, pred, batch["out_feats"],
                batch["lengths"], out_scaler, writer, first))
        return metrics, pred

    return run_epochs(config, out_dir, logger, device, batches, pitch_reg,
                      run_batch, lambda: TrainState.capture(
                          module, optimizer, scheduler, steps[0]), observe,
                      mesh)
