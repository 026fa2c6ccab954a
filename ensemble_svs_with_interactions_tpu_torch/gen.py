"""Generation pipeline pieces on the flagship path: the device-resident
model pack and the host-side timing helpers (counterparts in
``ensemble_svs_with_interactions_tpu/gen.py``).

Host (NumPy): linguistic featurization, note bookkeeping, duration
normalization.  Device (torch): model inference, with frame counts padded
to buckets as in the JAX package so both see the same padded inputs.
"""

from __future__ import annotations

import inspect
import math
from typing import Any

import numpy as np
import torch

from ensemble_svs_with_interactions_tpu_torch.base import PredictionType
from ensemble_svs_with_interactions_tpu_torch.frontend import merlin as fe
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    get_windows,
    multi_stream_mlpg,
)
from ensemble_svs_with_interactions_tpu_torch.ops.pitch import interp1d
from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
    MinMaxScaler,
)

# frame-level models pad to multiples of 512 frames, note/phone-level
# models to multiples of 64 (the JAX package's buckets)
FRAME_BUCKET = 512
PHONE_BUCKET = 64
# seed of the AR decoder's inference-time dropout (the JAX package's
# PRNGKey(1234))
AR_SEED = 1234


def _round_up(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple)


def midi_to_hz(x: np.ndarray, idx: int, log_f0: bool = False) -> np.ndarray:
    """MIDI note column -> Hz (0 stays 0), optionally log."""
    z = np.zeros(len(x))
    nz = x[:, idx] > 0
    z[nz] = 440.0 * 2.0 ** ((x[nz, idx] - 69) / 12.0)
    if log_f0:
        z[nz] = np.log(z[nz])
    return z


class ModelPack:
    """A model with its weights resident on the device once, its stream
    config, and bucketed batch inference.

    Models that sample at inference (the AR F0 decoder's prenet dropout)
    get a CPU ``torch.Generator`` seeded with ``AR_SEED`` afresh on every
    call, so each call is reproducible, as the JAX package's fixed key
    makes it, and draws the same masks on every device.
    """

    def __init__(self, module, config: Any, bucket: int = FRAME_BUCKET,
                 device="cuda"):
        self.device = torch.device(device)
        self.module = module.to(self.device).eval()
        self.config = config
        self.bucket = bucket

    def prediction_type(self):
        return self.module.prediction_type()

    def _takes_generator(self, method: str) -> bool:
        fn = getattr(self.module, method)
        return "generator" in inspect.signature(fn).parameters

    def _pack(self, seqs, B: int, T_pad: int):
        b = np.zeros((B, T_pad, seqs[0].shape[1]), np.float32)
        for i, s in enumerate(seqs):
            b[i, : len(s)] = s
        return torch.from_numpy(b).to(self.device)

    @torch.no_grad()
    def inference_batch(self, xs, spks=None, sub_index=None,
                        method="inference", block=True, device_out=False):
        """Batched inference over a list of (T_i, D) sequences, padded to a
        common bucketed length and run as one (B, T, D) batch.

        ``sub_index`` (per-item index into ``xs``) gathers the sub-track
        features of multitrack models on the device.  ``spks`` is a tuple
        of per-item speaker-id sequences.
        ``device_out=True`` returns ``(device output, lengths)`` with no
        host copy; otherwise per-item host arrays trimmed to their lengths
        (a zero-argument callable producing them when ``block=False``).
        """
        B = len(xs)
        T_pad = _round_up(max(len(x) for x in xs), self.bucket)
        lengths = np.asarray([len(x) for x in xs], np.int64)
        x = self._pack(xs, B, T_pad)
        args = [x]
        if sub_index is not None:
            idx = torch.as_tensor(np.asarray(sub_index, np.int64),
                                  device=self.device)
            args.append(x.index_select(0, idx))
        if spks is not None:
            args.append(tuple(
                torch.as_tensor(np.asarray(s, np.int64), device=self.device)
                for s in spks))
        kw = {"lengths": torch.as_tensor(lengths, device=self.device)}
        if self._takes_generator(method):
            kw["generator"] = torch.Generator().manual_seed(AR_SEED)
        out = getattr(self.module, method)(*args, **kw)
        if device_out:
            return out, lengths

        def _finalize():
            if isinstance(out, tuple):
                host = [o.cpu().numpy() for o in out]
                return [tuple(h[i, : lengths[i]] for h in host)
                        for i in range(B)]
            host = out.cpu().numpy()
            return [host[i, : lengths[i]] for i in range(B)]

        return _finalize() if block else _finalize


def _prepare_linguistic_features(labels, binary_dict, numeric_dict, in_scaler,
                                 pitch_indices, add_frame_features: bool,
                                 subphone_features, log_f0_conditioning: bool,
                                 force_clip_input_features: bool,
                                 frame_shift: int,
                                 return_raw: bool = False):
    raw = fe.linguistic_features(
        labels, binary_dict, numeric_dict,
        add_frame_features=add_frame_features,
        subphone_features=subphone_features, frame_shift=frame_shift,
    ).astype(np.float32, copy=False)
    feats = raw.copy() if return_raw else raw
    if log_f0_conditioning:
        for idx in pitch_indices:
            feats[:, idx] = interp1d(midi_to_hz(feats, idx, True))
    feats = np.asarray(in_scaler.transform(feats), dtype=np.float32)
    if force_clip_input_features and isinstance(in_scaler, MinMaxScaler):
        # clip everything except the pitch columns
        lo, hi = in_scaler.feature_range
        saved_pitch = feats[:, pitch_indices].copy()
        np.clip(feats, lo, hi, out=feats)
        feats[:, pitch_indices] = saved_pitch
    if return_raw:
        return feats, raw
    return feats


def _denorm_and_mlpg(pred, out_scaler, config, is_probabilistic: bool):
    """Denormalization + per-stream MLPG where delta windows are modeled.
    Probabilistic predictions ``(mu, sigma)`` solve with the predicted
    variance."""
    has_dyn = np.any(config.has_dynamic_features)
    if is_probabilistic and not isinstance(pred, tuple):
        is_probabilistic = False
    if is_probabilistic:
        mu, sigma = pred
        if has_dyn:
            sigma_sq = np.maximum(
                np.asarray(sigma) ** 2 * np.asarray(out_scaler.var_), 1e-14)
            mu = np.asarray(out_scaler.inverse_transform(mu))
            return multi_stream_mlpg(
                mu, sigma_sq, get_windows(config.num_windows),
                list(config.stream_sizes), list(config.has_dynamic_features))
        return np.asarray(out_scaler.inverse_transform(mu))
    out = np.asarray(out_scaler.inverse_transform(pred))
    if has_dyn:
        out = multi_stream_mlpg(
            out, np.asarray(out_scaler.var_), get_windows(config.num_windows),
            list(config.stream_sizes), list(config.has_dynamic_features))
    return out


def _clip_timelag(lag, note_labels, allowed_range, allowed_range_rest):
    """Round the per-note timelag (frames) and clip it to the allowed range
    (the wider rest range on silence-context notes)."""
    lag = np.round(lag)
    for idx in range(len(lag)):
        rng = (allowed_range_rest
               if hts.is_silence_context(note_labels.contexts[idx])
               else allowed_range)
        lag[idx] = np.clip(lag[idx], rng[0], rng[1])
    return lag


def _denorm_duration_pred(pred, duration_model, duration_out_scaler):
    """MDN models -> real-unit ``(mu, sigma_sq)``; deterministic models ->
    rounded durations floored at 1."""
    if duration_model.prediction_type() == PredictionType.PROBABILISTIC:
        mu, sigma = pred
        if np.any(duration_model.config.has_dynamic_features):
            raise RuntimeError("dynamic features are not supported for "
                               "durations")
        sigma_sq = np.maximum(
            np.asarray(sigma) ** 2 * np.asarray(duration_out_scaler.var_),
            1e-14)
        mu = np.asarray(duration_out_scaler.inverse_transform(mu))
        return mu, sigma_sq
    out = _denorm_and_mlpg(pred, duration_out_scaler, duration_model.config,
                           False)
    out[out <= 0] = 1
    return np.round(out)


def postprocess_duration(labels, pred_durations, lag,
                         frame_period: float = 5):
    """Note-level duration normalization from predicted lags and durations
    (arXiv:2108.02776 eqs. 11-17): note lengths corrected by the lag
    difference; MDN predictions use variance scaling with a uniform
    fallback on negative durations.  Returns (labels, cumulative d_norm)."""
    hts_frame_shift = int(frame_period * 1e4)
    labels = labels.copy()
    labels.frame_shift = hts_frame_shift
    labels.round_()
    note_indices = hts.get_note_indices(labels)
    note_indices.append(len(labels))
    is_mdn = isinstance(pred_durations, tuple) and len(pred_durations) == 2

    output = hts.HTSLabels(frame_shift=labels.frame_shift)
    d_norms = []
    for i in range(1, len(note_indices)):
        p = labels[note_indices[i - 1]: note_indices[i]]
        L = int(np.asarray(fe.duration_features(
            p, frame_shift=hts_frame_shift)).reshape(-1)[0])
        if i < len(note_indices) - 1:
            L_hat = L - (lag[i - 1] - lag[i]) / hts_frame_shift
        else:
            L_hat = L - lag[i - 1] / hts_frame_shift
        L_hat = max(float(np.asarray(L_hat).reshape(-1)[0]), 1.0)

        starts = np.minimum(
            np.asarray(p.start_times)
            + int(np.asarray(lag[i - 1]).reshape(-1)[0]),
            np.asarray(p.end_times) - hts_frame_shift * len(p))
        starts = np.maximum(starts, 0)
        if len(output) > 0:
            starts = np.maximum(starts,
                                output.start_times[-1] + hts_frame_shift)
        p.start_times = [int(s) for s in starts]

        if is_mdn:
            mu = pred_durations[0][note_indices[i - 1]: note_indices[i]]
            sigma_sq = pred_durations[1][note_indices[i - 1]: note_indices[i]]
            rho = (L_hat - mu.sum()) / sigma_sq.sum()
            d_norm = mu + rho * sigma_sq
            if np.any(d_norm <= 0):
                d_norm = L_hat * mu / mu.sum()
        else:
            d_hat = pred_durations[note_indices[i - 1]: note_indices[i]]
            d_norm = L_hat * d_hat / d_hat.sum()

        d_norm = np.round(d_norm)
        d_norm[d_norm <= 0] = 1
        d_norms += np.cumsum(d_norm.reshape(-1)).tolist()

        s0 = int(p.start_times[0])
        offsets = np.concatenate(
            [[0], np.cumsum(d_norm.reshape(-1))]).astype(np.int64)
        p.start_times = [s0 + int(o) * hts_frame_shift for o in offsets[:-1]]
        p.end_times = [s0 + int(o) * hts_frame_shift for o in offsets[1:]]

        if len(output) > 0:
            output.end_times[-1] = p.start_times[0]
        for entry in p:
            output.append(entry, strict=False)
    return output, np.asarray(d_norms)
