"""Objective evaluation metrics of the dev passes, with the JAX package's
formulas (``ensemble_svs_with_interactions_tpu/train/metrics.py``,
nnmnkwii-compatible):

  melcd  = (10 * sqrt(2) / ln 10) * mean_t ||x_t - y_t||_2
  vuv    = mean_t [x_t != y_t]           (fraction)
  f0 rmse: linear-domain MSE over frames voiced in BOTH, then sqrt.

NumPy on the host; tensors (on any device) are copied to the host first.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    get_static_features,
)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


_MELCD_COEF = 10.0 * np.sqrt(2.0) / np.log(10.0)


def _valid_frames(x, lengths):
    """Stack valid frames of a (B, T, D) batch into (sum_T, D)."""
    if lengths is None:
        return x.reshape(-1, x.shape[-1])
    parts = [x[b, : int(L)] for b, L in enumerate(lengths)]
    return np.concatenate(parts, axis=0)


def melcd(x, y, lengths=None) -> float:
    """Mel-cepstral distortion in dB."""
    x = _np(x)
    y = _np(y)
    if x.ndim == 3:
        x = _valid_frames(x, lengths)
        y = _valid_frames(y, lengths)
    return float(_MELCD_COEF * np.mean(np.sqrt(np.sum((x - y) ** 2, axis=-1))))


def vuv_error(x, y, lengths=None) -> float:
    """V/UV mismatch fraction."""
    x = _np(x)
    y = _np(y)
    if x.ndim == 3:
        x = _valid_frames(x, lengths)
        y = _valid_frames(y, lengths)
    return float(np.mean(x != y))


def lf0_mean_squared_error(
    lf0, vuv, pred_lf0, pred_vuv, lengths=None, linear_domain: bool = False
) -> float:
    """MSE of (log-)F0 over frames voiced in both reference and prediction."""
    lf0 = _np(lf0)
    pred_lf0 = _np(pred_lf0)
    vuv = _np(vuv)
    pred_vuv = _np(pred_vuv)
    if lf0.ndim == 3:
        lf0 = _valid_frames(lf0, lengths)
        pred_lf0 = _valid_frames(pred_lf0, lengths)
        vuv = _valid_frames(vuv, lengths)
        pred_vuv = _valid_frames(pred_vuv, lengths)
    both = ((vuv > 0) & (pred_vuv > 0)).reshape(-1)
    if both.sum() == 0:
        raise ZeroDivisionError("no frames voiced in both")
    a = lf0.reshape(len(both), -1)[both]
    b = pred_lf0.reshape(len(both), -1)[both]
    if linear_domain:
        a, b = np.exp(a), np.exp(b)
    return float(np.mean((a - b) ** 2))


def mean_squared_error(x, y, lengths=None) -> float:
    x = _np(x)
    y = _np(y)
    if x.ndim == 3:
        x = _valid_frames(x, lengths)
        y = _valid_frames(y, lengths)
    return float(np.mean((x - y) ** 2))


def compute_distortions(
    pred_out_feats,
    out_feats,
    lengths,
    out_scaler,
    stream_sizes: Sequence[int],
    has_dynamic_features: Sequence[bool],
    num_windows: int,
) -> Dict[str, float]:
    """MGC-MCD, BAP-MCD, V/UV error, F0-RMSE on denormalized statics."""
    out_feats = _np(out_scaler.inverse_transform(_np(out_feats)))
    pred_out_feats = _np(out_scaler.inverse_transform(_np(pred_out_feats)))
    out_streams = get_static_features(
        out_feats, num_windows, list(stream_sizes), list(has_dynamic_features))
    pred_streams = get_static_features(
        pred_out_feats, num_windows, list(stream_sizes),
        list(has_dynamic_features))

    if len(out_streams) >= 4:
        mgc, lf0, vuv, bap = out_streams[:4]
        pred_mgc, pred_lf0, pred_vuv, pred_bap = pred_streams[:4]
    elif len(out_streams) == 3:
        mgc, lf0, vuv = out_streams
        pred_mgc, pred_lf0, pred_vuv = pred_streams
        bap = pred_bap = None
    else:
        raise ValueError(f"unsupported stream count: {len(out_streams)}")

    vuv = (vuv > 0.5).astype(np.float32)
    pred_vuv = (pred_vuv > 0.5).astype(np.float32)

    dist = {
        "ObjEval_MGC_MCD": melcd(mgc[..., 1:], pred_mgc[..., 1:], lengths),
        "ObjEval_VUV_ERR": vuv_error(vuv, pred_vuv, lengths),
    }
    if bap is not None:
        dist["ObjEval_BAP_MCD"] = melcd(bap, pred_bap, lengths) / 10.0
    try:
        dist["ObjEval_F0_RMSE"] = float(
            np.sqrt(
                lf0_mean_squared_error(
                    lf0, vuv, pred_lf0, pred_vuv, lengths, linear_domain=True
                )
            )
        )
    except ZeroDivisionError:
        pass
    return dist
