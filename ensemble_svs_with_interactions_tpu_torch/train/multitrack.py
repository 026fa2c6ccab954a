"""Multitrack training: the interaction losses, the acoustic train step
and the timelag/duration train step, as
``ensemble_svs_with_interactions_tpu/train/multitrack.py`` defines them.

A step updates a module, its optimizer and its scheduler in place, on
``device="cuda"`` unless the caller passes ``"cpu"``.  It runs the
forward, the losses, the backward (every LSTM through the hand-written
BPTT kernels on the card), the JAX package's clipping
``min(1, clip / max(|g|, 1e-12))``, the NaN-skip and the optimizer update.
``use_amp=True`` runs the forward and backward in bfloat16 over float32
master parameters (``train.loop.amp_cast``); the LSTM recurrences stay
float32 (``models.layers.lstm_sequence``), and the losses, clipping and
optimizer are float32.  Donation has no counterpart: the update is in
place.  The NaN-skip leaves the parameters and the optimizer state as
they were in both steps; the JAX timing step guards only its parameters.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from ensemble_svs_with_interactions_tpu_torch.base import PredictionType
from ensemble_svs_with_interactions_tpu_torch.ops.mdn import (
    mdn_get_most_probable_sigma_and_mu,
)
from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    split_streams,
)
from ensemble_svs_with_interactions_tpu_torch.train import losses as L
from ensemble_svs_with_interactions_tpu_torch.train.loop import (
    amp_forward,
    apply_update,
    clip_grads,
    global_metrics,
    metrics_to_floats,
    param_grads,
    reduce_grads,
)

BATCH_KEYS = ("in_feats0", "in_feats1", "out_feats0", "out_feats1", "spks0",
              "spks1", "lengths")
TIMING_BATCH_KEYS = ("in_feats0", "in_feats1", "out_feats0", "spks0",
                     "spks1", "lengths", "mask0")
FEATURE_KEYS = ("in_feats0", "in_feats1", "out_feats0", "out_feats1")


def interaction_weight(spec, epoch: int, nepochs: int) -> float:
    """Resolve a static or 'exponential'-scheduled interaction weight."""
    if spec == "exponential":
        return float(2.0 ** ((epoch - nepochs) / 10.0))
    return float(spec if spec is not None else 0.0)


def _stream_to_point(pred_stream):
    """Reduce a stream prediction to a point estimate (mu for MDN)."""
    if isinstance(pred_stream, list):
        pred_stream = pred_stream[-1]
    if isinstance(pred_stream, tuple) and len(pred_stream) == 3:
        return mdn_get_most_probable_sigma_and_mu(*pred_stream)[1]
    if isinstance(pred_stream, tuple) and len(pred_stream) == 2:
        return pred_stream[1]
    return pred_stream


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detach(t) for t in tree)
    return tree


def multitrack_acoustic_loss(pred_main, pred_sub, out_main, out_sub, mask,
                             stream_sizes, criterion: str = "mse",
                             sub_require_grad: bool = True,
                             prediction_type=PredictionType.MULTISTREAM_HYBRID):
    """(loss_feats, loss_lf0_inter, loss_mgc0_inter) of a multitrack
    acoustic model.  The feature loss is the main track's; the sub track
    is trained through the interaction terms (detached with
    ``sub_require_grad=False``).  The log-F0 interaction is taken on frames
    voiced in BOTH tracks; the 0th-mel-cepstrum interaction is 0 for hybrid
    multistream models, as in the reference."""
    if not sub_require_grad:
        pred_sub = _detach(pred_sub)
    stream_sizes = list(stream_sizes)
    streams_main = split_streams(out_main, stream_sizes)
    streams_sub = split_streams(out_sub, stream_sizes)

    pred_main_stages = None
    if L.is_refinement_list(pred_main, stream_sizes):
        pred_main_stages = pred_main
        pred_main = pred_main[-1]
    if L.is_refinement_list(pred_sub, stream_sizes):
        pred_sub = pred_sub[-1]

    hybrid = prediction_type == PredictionType.MULTISTREAM_HYBRID
    if hybrid:
        if not isinstance(pred_main, (list, tuple)):
            pred_main = split_streams(pred_main, stream_sizes)
        if not isinstance(pred_sub, (list, tuple)):
            pred_sub = split_streams(pred_sub, stream_sizes)
        loss_feats = L.multistream_loss(pred_main, out_main, mask,
                                        stream_sizes, criterion=criterion)
        pred_lf0_main = _stream_to_point(pred_main[1])
        pred_lf0_sub = _stream_to_point(pred_sub[1])
    else:
        stages = pred_main_stages if pred_main_stages is not None else [
            pred_main]
        loss_feats = sum(L.feats_criterion(p, out_main, mask, criterion)
                         for p in stages)
        pm = split_streams(pred_main, stream_sizes)
        ps = split_streams(pred_sub, stream_sizes)
        pred_lf0_main, pred_lf0_sub = pm[1], ps[1]
        pred_mgc_main, pred_mgc_sub = pm[0], ps[0]

    both_voiced = ((streams_main[2] > 0) & (streams_sub[2] > 0)).to(
        mask.dtype)
    loss_lf0_inter = L.masked_mean(
        L._error(pred_lf0_main - pred_lf0_sub,
                 streams_main[1] - streams_sub[1], criterion),
        mask * both_voiced)

    if hybrid:
        loss_mgc0_inter = torch.zeros((), device=mask.device)
    else:
        loss_mgc0_inter = L.masked_mean(
            L._error(pred_mgc_main[..., :1] - pred_mgc_sub[..., :1],
                     streams_main[0][..., :1] - streams_sub[0][..., :1],
                     criterion), mask)
    return loss_feats, loss_lf0_inter, loss_mgc0_inter


def _batch_to_device(batch, keys, device, dtype):
    """The batch's tensors on ``device``: features in ``dtype`` (the
    module's: float64 oracles), ids and lengths as int64."""
    out = {k: torch.as_tensor(batch[k], device=device) for k in keys}
    for k in keys:
        if k in FEATURE_KEYS:
            out[k] = out[k].to(dtype)
        elif k in ("spks0", "spks1", "lengths"):
            out[k] = out[k].long()
    return out


def create_multitrack_acoustic_train_step(
    module,
    optimizer,
    model_config: Dict,
    scheduler=None,
    clip_norm: float = 1.0,
    feats_criterion: str = "mse",
    pitch_reg_weight: float = 1.0,
    sub_require_grad: bool = True,
    use_amp: bool = False,
    device="cuda",
):
    """(train_step, eval_step) for the multitrack acoustic model.

    ``module`` is moved to ``device``; ``optimizer`` (and ``scheduler``,
    from :func:`train.loop.build_optimizer`) must be built over its
    parameters.  ``train_step(batch, weights, generator)`` takes a batch
    dict (``BATCH_KEYS``, arrays or tensors; ``pitch_reg_dyn_ws``
    optional), the interaction weights ``{"logf0_diff", "mgc_diff"}`` and
    the ``torch.Generator`` that draws every dropout mask, updates the
    module, optimizer and scheduler in place, and returns the metrics as
    floats.  A non-finite loss or gradient norm leaves the parameters, the
    optimizer state and the schedule untouched (the batch-norm statistics
    are updated all the same, as in the JAX step).  ``use_amp=True`` casts
    the parameters, buffers, input features and teacher-forcing targets to
    bfloat16 for the forward and the outputs back to float32 for the
    losses, which take the float32 targets.
    ``train_step(..., blocked_phase_times=True)`` synchronizes the device
    after the forward, the backward and the optimizer and records their
    seconds in ``train_step.last_phase_times``.
    ``eval_step(batch, weights)`` returns (metrics, main-track prediction)
    without touching anything (prenet dropout from a generator seeded 0).
    """
    device = torch.device(device)
    module.to(device)
    stream_sizes = list(model_config.get("stream_sizes", [60, 1, 1, 5]))
    prediction_type = module.prediction_type()
    params = [p for p in module.parameters() if p.requires_grad]
    dtype = params[0].dtype  # features follow the module (float64 oracles)

    def to_device(batch):
        out = _batch_to_device(batch, BATCH_KEYS, device, dtype)
        out["pitch_reg_dyn_ws"] = (
            torch.as_tensor(batch["pitch_reg_dyn_ws"], device=device).to(dtype)
            if "pitch_reg_dyn_ws" in batch else 1.0)
        return out

    def loss_fn(b, weights, generator, train: bool):
        T = b["in_feats0"].shape[1]
        mask = (torch.arange(T, device=device)[None, :]
                < b["lengths"][:, None]).to(dtype)[:, :, None]
        (pred_main, lf0_res_main), (pred_sub, _) = amp_forward(
            module, (b["in_feats0"], b["in_feats1"], (b["spks0"], b["spks1"]),
                     b["lengths"], (b["out_feats0"], b["out_feats1"])),
            {"train": train, "generator": generator}, use_amp, train)
        loss_feats, loss_lf0_inter, loss_mgc0_inter = multitrack_acoustic_loss(
            pred_main, pred_sub, b["out_feats0"], b["out_feats1"], mask,
            stream_sizes, criterion=feats_criterion,
            sub_require_grad=sub_require_grad,
            prediction_type=prediction_type)
        loss_pitch = (L.pitch_regularization_loss(
            lf0_res_main, mask, b["pitch_reg_dyn_ws"])
            if pitch_reg_weight > 0 else torch.zeros((), device=device))
        loss = (loss_feats + pitch_reg_weight * loss_pitch
                + float(weights["logf0_diff"]) * loss_lf0_inter
                + float(weights["mgc_diff"]) * loss_mgc0_inter)
        metrics = {"Loss": loss, "Loss_Feats": loss_feats,
                   "Loss_Pitch": loss_pitch,
                   "Loss_LogF0_Interaction": loss_lf0_inter,
                   "Loss_MGC-0th_Interaction": loss_mgc0_inter}
        return loss, metrics, pred_main

    def lap(times, name, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        times[name] = t1 - t0
        return t1

    def train_step(batch, weights, generator, blocked_phase_times=False):
        times = {}
        t0 = time.perf_counter()
        b = to_device(batch)
        optimizer.zero_grad(set_to_none=False)
        loss, metrics, _ = loss_fn(b, weights, generator, True)
        if blocked_phase_times:
            t0 = lap(times, "forward", t0)
        loss.backward()
        metrics = reduce_grads(param_grads(params), metrics)
        gnorm, finite = clip_grads(params, metrics["Loss"], clip_norm)
        if blocked_phase_times:
            t0 = lap(times, "backward", t0)
        metrics["GradNorm"] = gnorm
        out = metrics_to_floats(metrics, device)
        apply_update(finite, optimizer, scheduler)
        if blocked_phase_times:
            lap(times, "optimizer", t0)
        train_step.last_phase_times = times
        return out

    train_step.last_phase_times = {}

    @torch.no_grad()
    def eval_step(batch, weights):
        generator = torch.Generator(device=device).manual_seed(0)
        _, metrics, pred_main = loss_fn(to_device(batch), weights, generator,
                                        False)
        return metrics_to_floats(global_metrics(metrics), device), pred_main

    return train_step, eval_step


def create_multitrack_timing_train_step(module, optimizer, scheduler=None,
                                        clip_norm: float = 1.0,
                                        use_amp: bool = False,
                                        device="cuda"):
    """(train_step, eval_step) for a multitrack timelag or duration model
    (``MultiTrackVariancePredictor``) over note-merged tracks.

    The input is ``concat(in_feats0, in_feats1)``; the target is the main
    track's ``out_feats0`` where the main track is present, so the mask
    is ``valid x mask0``.  The loss is the masked MDN negative
    log-likelihood for a probabilistic model, else the masked MSE.
    ``train_step(batch, generator)`` takes a batch dict
    (``TIMING_BATCH_KEYS``) and the ``torch.Generator`` of the dropout
    masks, updates the module, optimizer and scheduler in place and
    returns ``{"Loss", "GradNorm"}`` as floats; ``eval_step(batch)``
    returns ``{"Loss"}``.  Clipping, the NaN-skip and ``use_amp`` as in
    :func:`create_multitrack_acoustic_train_step`."""
    device = torch.device(device)
    module.to(device)
    probabilistic = module.prediction_type() == PredictionType.PROBABILISTIC
    params = [p for p in module.parameters() if p.requires_grad]
    dtype = params[0].dtype

    def loss_fn(b, generator, train: bool):
        x = torch.cat([b["in_feats0"], b["in_feats1"]], dim=-1)
        T = x.shape[1]
        valid = (torch.arange(T, device=device)[None, :]
                 < b["lengths"][:, None]).to(dtype)
        mask = (valid * b["mask0"].to(dtype))[:, :, None]
        pred = amp_forward(module, (x, (b["spks0"], b["spks1"]), b["lengths"]),
                        {"train": train, "generator": generator}, use_amp,
                        train)
        if probabilistic:
            return L.mdn_stream_loss(pred, b["out_feats0"], mask)
        return L.feats_criterion(pred, b["out_feats0"], mask, "mse")

    def train_step(batch, generator):
        b = _batch_to_device(batch, TIMING_BATCH_KEYS, device, dtype)
        optimizer.zero_grad(set_to_none=False)
        loss = loss_fn(b, generator, True)
        loss.backward()
        metrics = reduce_grads(param_grads(params), {"Loss": loss})
        gnorm, finite = clip_grads(params, metrics["Loss"], clip_norm)
        out = metrics_to_floats({**metrics, "GradNorm": gnorm}, device)
        apply_update(finite, optimizer, scheduler)
        return out

    @torch.no_grad()
    def eval_step(batch):
        b = _batch_to_device(batch, TIMING_BATCH_KEYS, device, dtype)
        return metrics_to_floats(global_metrics(
            {"Loss": loss_fn(b, None, False)}), device)

    return train_step, eval_step
