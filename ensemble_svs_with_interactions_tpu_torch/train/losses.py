"""Training losses: masked feature criteria, the multistream dispatch and
the pitch regularization, as ``ensemble_svs_with_interactions_tpu/train/
losses.py`` defines them.  Plain torch ops on the training device; the
pitch regularization's per-frame weights are NumPy, built on the host with
each batch.

Under a process group (``parallel/mesh.py``) every normaliser is the
GLOBAL count, the sum of the ranks' counts (:func:`global_count`), so each
rank's loss is its own numerator over the global count, the ranks' losses
sum to the global-batch loss and their summed gradients are its gradient,
as the JAX package's one global-view program computes it."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ensemble_svs_with_interactions_tpu_torch.ops.mdn import mdn_loss
from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    split_streams,
)
from ensemble_svs_with_interactions_tpu_torch.ops.pitch import note_segments
from ensemble_svs_with_interactions_tpu_torch.parallel.mesh import (
    all_reduce_sum,
)


def global_count(count):
    """A normaliser: the count summed over the process group (no
    gradient), at least 1."""
    return torch.clamp(all_reduce_sum(torch.as_tensor(count)), min=1.0)


def masked_mean(x, mask):
    """Mean of x over positions where mask (broadcastable) is 1, over the
    global batch."""
    mask = torch.broadcast_to(mask, x.shape)
    return (x * mask).sum() / global_count(mask.sum())


def _error(pred, target, kind: str):
    if kind in ("l2", "mse"):
        return (pred - target) ** 2
    if kind in ("l1", "mae"):
        return torch.abs(pred - target)
    raise ValueError(f"unsupported criterion: {kind}")


def feats_criterion(pred, target, mask, kind: str = "mse"):
    return masked_mean(_error(pred, target, kind), mask)


def mdn_stream_loss(pred, target, mask):
    """Masked MDN negative log-likelihood; pred = (log_pi, log_sigma, mu)."""
    nll = mdn_loss(*pred, target, reduce=False)
    return masked_mean(nll, mask if nll.ndim == 3 else mask[..., 0])


def get_stream_weight(stream_weights: Optional[Sequence[float]],
                      stream_sizes: Sequence[int]):
    if stream_weights is not None:
        return list(stream_weights)
    total = float(sum(stream_sizes))
    return [s / total for s in stream_sizes]


def is_refinement_list(pred, stream_sizes: Sequence[int]) -> bool:
    """True when ``pred`` is a Post-Net wrapper's ``[coarse, fine, ...]``
    list of CONCATENATED outputs (each item full-width), as opposed to a
    per-stream list whose item widths match ``stream_sizes``."""
    if not isinstance(pred, list) or not pred:
        return False
    widths = [p.shape[-1] if getattr(p, "ndim", 0) else None for p in pred]
    if len(pred) == len(stream_sizes) and widths == list(stream_sizes):
        return False
    total = sum(stream_sizes)
    return all(w == total for w in widths)


def multistream_loss(pred_streams, out_feats, mask,
                     stream_sizes: Sequence[int], criterion: str = "mse",
                     stream_wise: bool = False,
                     stream_weights: Optional[Sequence[float]] = None):
    """Sum of per-stream losses.  A stream's prediction is an array (the
    criterion), a list (Post-Net stages, each supervised), a 3-tuple (MDN
    NLL) or a 2-tuple (diffusion noise against its reconstruction).
    Without ``stream_wise`` the sum is over every element and is divided
    by the total count of valid elements."""
    streams = split_streams(out_feats, list(stream_sizes))
    if len(streams) != len(pred_streams):
        raise ValueError(f"{len(pred_streams)} predicted streams for "
                         f"{len(streams)} target streams")
    weights = (get_stream_weight(stream_weights, stream_sizes)
               if stream_wise else None)
    loss = 0.0
    total_n = 0.0

    def add(i, err, m):
        nonlocal loss, total_n
        m = torch.broadcast_to(m, err.shape)
        if stream_wise:
            loss = loss + weights[i] * masked_mean(err, m)
        else:
            loss = loss + (err * m).sum()
            total_n = total_n + m.sum()

    for i, (pred, target) in enumerate(zip(pred_streams, streams)):
        if isinstance(pred, list):
            for p in pred:
                add(i, _error(p, target, criterion), mask)
        elif isinstance(pred, tuple) and len(pred) == 3:
            nll = mdn_loss(*pred, target, reduce=False)
            add(i, nll, mask if nll.ndim == 3 else mask[..., 0])
        elif isinstance(pred, tuple) and len(pred) == 2:
            noise, x_recon = pred
            add(i, (noise - x_recon) ** 2, mask)
        else:
            add(i, _error(pred, target, criterion), mask)
    if not stream_wise:
        loss = loss / global_count(total_n)
    return loss


def pitch_regularization_loss(lf0_residual, mask, pitch_reg_dyn_ws=1.0):
    """L1 penalty on the residual log-F0 with per-frame dynamic weights."""
    if isinstance(lf0_residual, (list, tuple)):
        return sum(masked_mean(pitch_reg_dyn_ws * torch.abs(r), mask)
                   for r in lf0_residual)
    return masked_mean(pitch_reg_dyn_ws * torch.abs(lf0_residual), mask)


def compute_pitch_regularization_weight(lf0_score_denorm: np.ndarray,
                                        decay_size: int = 25,
                                        max_w: float = 0.5) -> np.ndarray:
    """(B, T) denormalized score log-F0 -> (B, T, 1) float32 weights: full
    weight inside notes, a linear decay over ``decay_size`` frames at note
    edges, zero for notes of ``2 * decay_size`` frames or fewer."""
    B, T = lf0_score_denorm.shape
    w = np.zeros((B, T), dtype=np.float32)
    for b in range(B):
        for s, e in note_segments(lf0_score_denorm[b]):
            if e - s > decay_size * 2:
                w[b, s:e] = max_w
                w[b, s: s + decay_size] *= np.arange(decay_size) / decay_size
                w[b, e - decay_size: e] *= (
                    np.arange(decay_size - 1, -1, -1) / decay_size)
            else:
                w[b, s:e] = 0.0
    return w[:, :, None]
