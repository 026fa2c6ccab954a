"""Point estimates of sub-model outputs and the residual-F0 machinery the
acoustic models share (``point_estimate``, ``concat_stream_outputs``,
``predict_lf0_with_residual`` and ``set_lf0_column`` of
``ensemble_svs_with_interactions_tpu/models/acoustic/util.py``)."""

from __future__ import annotations

import torch

from ensemble_svs_with_interactions_tpu_torch.models.tacotron import (
    lf0_residual,
)
from ensemble_svs_with_interactions_tpu_torch.ops.mdn import (
    mdn_get_most_probable_sigma_and_mu,
)


def point_estimate(pred):
    """MDN heads' ``(log_pi, log_sigma, mu)`` -> most probable mean; AR MDN
    ``(mu, sigma)`` -> mu; Post-Net ``[coarse, fine]`` -> fine; arrays as
    they are."""
    if isinstance(pred, list):
        pred = pred[-1]
    if isinstance(pred, tuple) and len(pred) == 3:
        return mdn_get_most_probable_sigma_and_mu(*pred)[1]
    if isinstance(pred, tuple) and len(pred) == 2:
        return pred[0]
    return pred


def concat_stream_outputs(parts, out_dim: int):
    """Per-stream decoder outputs concatenated into the full feature
    vector; where a decoder returned a Post-Net ``[coarse, fine]`` list,
    a list of concatenations, one per refinement stage."""
    if any(isinstance(p, list) for p in parts):
        n = max(len(p) for p in parts if isinstance(p, list))
        outs = []
        for idx in range(n):
            out = torch.cat([p[idx] if isinstance(p, list) else p
                             for p in parts], dim=-1)
            assert out.shape[-1] == out_dim
            outs.append(out)
        return outs
    out = torch.cat(list(parts), dim=-1)
    assert out.shape[-1] == out_dim
    return out


def predict_lf0_with_residual(in_feats, out_feats, in_lf0_idx: int = 300,
                              in_lf0_min: float = 5.3936276,
                              in_lf0_max: float = 6.491111,
                              out_lf0_idx: int = 180,
                              out_lf0_mean: float = 5.953093881972361,
                              out_lf0_scale: float = 0.23435173188961034):
    """(lf0_pred, lf0_residual): the score's denormalized lf0 plus the
    residual bounded to +-600 cents by a scaled tanh of the output's lf0
    column, renormalized to the output scaler's domain.  ``out_feats`` is
    (B, T, D) (results (B, T, 1)) or MDN means (B, T, G, D) (results
    (B, T, G)).  The residual and the sum are float32 at least, as the
    JAX package's float64 ratio makes them (``models/tacotron.
    lf0_residual``)."""
    lf0_score = in_feats[:, :, in_lf0_idx][..., None]
    lf0_score_denorm = lf0_score * (in_lf0_max - in_lf0_min) + in_lf0_min
    if out_feats.ndim == 4:
        raw = out_feats[:, :, :, out_lf0_idx]
    else:
        raw = out_feats[:, :, out_lf0_idx][..., None]
    residual = lf0_residual(raw)
    lf0_pred = (lf0_score_denorm + residual - out_lf0_mean) / out_lf0_scale
    return lf0_pred, residual


def set_lf0_column(out_feats, lf0_pred, out_lf0_idx: int):
    """``out_feats`` with its lf0 column replaced by ``lf0_pred`` (in
    ``out_feats``' dtype), for (B, T, D) or (B, T, G, D)."""
    out = out_feats.clone()
    if out_feats.ndim == 4:
        out[:, :, :, out_lf0_idx] = lf0_pred.to(out.dtype)
    else:
        out[:, :, out_lf0_idx] = lf0_pred[..., 0].to(out.dtype)
    return out
