"""Generation pipeline pieces (counterparts in
``ensemble_svs_with_interactions_tpu/gen.py``): the device-resident model
pack, timing, acoustic prediction, the host postprocess of the acoustic
streams and the waveform stages.

Host (NumPy/SciPy): linguistic featurization, note bookkeeping, duration
normalization, the GV and merlin postfilters, stream reconstruction (WORLD
streams, or the mel voices' (mel, lf0, vuv)),
trajectory smoothing, the decoding of uncoded WORLD features
(``gen_world_params``) and the waveform's band-pass and normalization.
Device (torch): model inference (the learned postfilter too), the WORLD
vocoder, with frame counts padded to buckets as in the JAX package so both
see the same padded inputs, and the neural vocoders (``pwg``, ``usfgan``),
unpadded as in the JAX package.
"""

from __future__ import annotations

import copy
import inspect
import math
from typing import Any

import numpy as np
import torch

from ensemble_svs_with_interactions_tpu_torch.base import PredictionType
from ensemble_svs_with_interactions_tpu_torch.frontend import merlin as fe
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.models.postfilters import (
    variance_scaling,
)
from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    get_static_stream_sizes,
    get_windows,
    multi_stream_mlpg,
    split_streams,
)
from ensemble_svs_with_interactions_tpu_torch.ops.pitch import (
    bandpass_filter,
    gen_sine_vibrato,
    interp1d,
    lowpass_filter,
)
from ensemble_svs_with_interactions_tpu_torch.ops.sptk import mc2sp, mcepalpha
from ensemble_svs_with_interactions_tpu_torch.ops.world.codec import (
    code_aperiodicity,
    decode_aperiodicity,
    decode_spectral_envelope_np,
    get_cheaptrick_fft_size,
)
from ensemble_svs_with_interactions_tpu_torch.ops.world.synthesis import (
    synthesize,
    synthesize_from_streams,
)
from ensemble_svs_with_interactions_tpu_torch.parallel.mesh import (
    drawing_rows,
)
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
# seed of the diffusion decoders' sampling chains (the JAX package feeds
# them a split of the same key)
CHAIN_SEED = 1234
# option -> the JAX package's module an unported option needs: none is
# left (the vibrato streams were the last)
UNPORTED: dict = {}


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

    Models that sample at inference get generators seeded afresh on
    every call, so each call is reproducible, as the JAX package's fixed
    key makes it: the AR F0 decoder's prenet dropout a CPU
    ``torch.Generator`` seeded with ``AR_SEED`` (the same masks on every
    device), the diffusion decoders' chains (``chain_generator``) one on
    the pack's device seeded with ``CHAIN_SEED``, so their noise is drawn
    where the chain runs.
    """

    def __init__(self, module, config: Any, bucket: int = FRAME_BUCKET,
                 device="cuda"):
        self.module = module.eval()
        self.config = config
        self.bucket = bucket
        self.mesh = None
        self.to(device)

    def to(self, device) -> "ModelPack":
        """Move the weights to ``device``; later calls run there."""
        self.device = torch.device(device)
        self.module.to(self.device)
        return self.set_mesh(self.mesh)

    def set_mesh(self, mesh) -> "ModelPack":
        """Shard each batch over the devices of ``mesh``
        (``parallel.make_mesh``; one process's): the module replicated on
        each device, the batch padded to a multiple of the mesh size with
        rows of length 1, each device running its contiguous rows (their
        launches overlap across cards; a repeated device runs its shards
        in turn).  Random draws are the whole batch's, cut to each shard's
        rows (``parallel.mesh.drawing_rows``).  The outputs are gathered on
        the pack's device, the padding rows dropped.  ``None`` returns to
        the pack's one device."""
        if mesh is not None and mesh.world_size > 1:
            raise ValueError("set_mesh: a mesh of one process's devices")
        self.mesh = mesh
        self._replicas = {self.device: self.module}
        for d in self._devices():
            if d not in self._replicas:
                self._replicas[d] = (self.module if _same_device(d, self.device)
                                     else copy.deepcopy(self.module).to(d))
        return self

    def _devices(self) -> tuple:
        return self.mesh.devices if self.mesh is not None else (self.device,)

    def prediction_type(self):
        return self.module.prediction_type()

    def _takes(self, method: str, arg: str) -> bool:
        return arg in inspect.signature(
            getattr(self.module, method)).parameters

    @torch.no_grad()
    def inference_batch(self, xs, spks=None, sub_index=None,
                        method="inference", block=True, device_out=False,
                        xs_sub=None):
        """Batched inference over a list of (T_i, D) sequences, padded to a
        common bucketed length and run as one (B, T, D) batch (over a mesh,
        ``set_mesh``: padded to a multiple of its size, one shard of rows a
        device, gathered on the pack's device without the padding rows).

        Multitrack models take the sub-track features as ``xs_sub`` (per
        item, padded with ``xs``) or, when they are a permutation of
        ``xs``, as ``sub_index`` (per-item index into ``xs``).  ``spks`` is
        a tuple of per-item speaker-id sequences, one a track, for
        multitrack models, or a single-track model's ids (an int, or an
        array of shape (B,) or (B, 1)).  ``device_out=True`` returns
        ``(device output, lengths)`` with no host copy; otherwise per-item
        host arrays trimmed to their lengths (a zero-argument callable
        producing them when ``block=False``).
        """
        devices = self._devices()
        B = len(xs)
        B_pad = _round_up(B, len(devices))
        T_pad = _round_up(max(len(x) for x in list(xs) + list(xs_sub or [])),
                          self.bucket)
        lengths = np.asarray([len(x) for x in xs], np.int64)
        x = np.zeros((B_pad, T_pad, xs[0].shape[1]), np.float32)
        for i, s in enumerate(xs):
            x[i, : len(s)] = s
        x_sub = None
        if sub_index is not None and len(devices) > 1:
            x_sub = x[_pad_rows(np.asarray(sub_index, np.int64), B_pad)]
        elif xs_sub is not None:
            x_sub = np.zeros_like(x)
            for i, s in enumerate(xs_sub):
                x_sub[i, : len(s)] = s
        if isinstance(spks, tuple):
            spks = tuple(_pad_rows(np.asarray(s, np.int64), B_pad)
                         for s in spks)
        elif spks is not None and np.ndim(spks) > 0:
            spks = _pad_rows(np.asarray(spks, np.int64), B_pad)
        # padding rows are zeros of length 1 (a length of 0 would divide
        # by zero in mask-normalised reductions of some models)
        lens = np.ones(B_pad, np.int64)
        lens[:B] = lengths
        per = B_pad // len(devices)
        outs = []
        for k, d in enumerate(devices):
            rows = slice(k * per, (k + 1) * per)
            args = [torch.from_numpy(x[rows]).to(d)]
            if x_sub is not None:
                args.append(torch.from_numpy(x_sub[rows]).to(d))
            elif sub_index is not None:  # one shard: gathered on the device
                args.append(args[0].index_select(0, torch.as_tensor(
                    np.asarray(sub_index, np.int64), device=d)))
            if spks is not None:
                args.append(_rows_on(spks, rows, d))
            kw = {"lengths": torch.from_numpy(lens[rows]).to(d)}
            if self._takes(method, "generator"):
                kw["generator"] = torch.Generator().manual_seed(AR_SEED)
            if self._takes(method, "chain_generator"):
                kw["chain_generator"] = torch.Generator(d).manual_seed(
                    CHAIN_SEED)
            with drawing_rows(rows, B_pad):
                outs.append(getattr(self._replicas[d], method)(*args, **kw))

        def gather(parts):
            if len(parts) == 1:
                return parts[0]
            return torch.cat([p.to(self.device) for p in parts])[:B]

        out = (tuple(gather([o[j] for o in outs]) for j in range(len(outs[0])))
               if isinstance(outs[0], tuple) else gather(outs))
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

    def inference(self, x: np.ndarray, spks=None, method: str = "inference",
                  x_sub=None):
        """Inference on one (T, D) sequence (with the sub track ``x_sub``
        for multitrack models), padded to the bucket with ``lengths =
        [T]``; host arrays trimmed to T (a tuple of them for MDN heads)."""
        return self.inference_batch(
            [x], spks=spks, method=method,
            xs_sub=None if x_sub is None else [x_sub])[0]


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` is the current card)."""
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index

    return a.type == b.type and index(a) == index(b)


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """``a`` with zero rows appended up to ``rows``."""
    pad = np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad])


def _rows_on(spks, rows: slice, device):
    """A shard's speaker ids on its device: a tuple of per-track ids, one
    tensor of ids, or an int for every row."""
    if isinstance(spks, tuple):
        return tuple(torch.from_numpy(s[rows]).to(device) for s in spks)
    if np.ndim(spks) == 0:
        return torch.as_tensor(np.asarray(spks, np.int64), device=device)
    return torch.from_numpy(spks[rows]).to(device)


def vocoder_noise(N: int, samples: int, device) -> torch.Tensor:
    """The WORLD vocoder's excitation noise, (N, samples) standard normal
    from a generator seeded 0 on ``device``, afresh on each call."""
    g = torch.Generator(device).manual_seed(0)
    return torch.randn((N, samples), generator=g, device=device)


def _prepare_linguistic_features(labels, binary_dict, numeric_dict, in_scaler,
                                 pitch_indices, add_frame_features: bool,
                                 subphone_features, log_f0_conditioning: bool,
                                 force_clip_input_features: bool,
                                 frame_shift: int,
                                 f0_shift_in_cent: float = 0.0,
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
            if f0_shift_in_cent != 0:
                feats[:, idx] += f0_shift_in_cent * np.log(2) / 1200
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


# ------------------------------------------------------------------ timing
def _timing_inputs(labels, binary_dict, numeric_dict, in_scaler,
                   pitch_indices, log_f0_conditioning, force_clip,
                   frame_shift):
    return _prepare_linguistic_features(
        labels, binary_dict, numeric_dict, in_scaler, pitch_indices, False,
        None, log_f0_conditioning, force_clip, frame_shift)


def _note_labels(labels, hts_frame_shift: int):
    """Round the labels to the frame grid in place (as the JAX package's
    timing steps do to the caller's labels) and return their notes."""
    labels.frame_shift = hts_frame_shift
    labels.round_()
    return labels[hts.get_note_indices(labels)]


def _lag_from_pred(pred, timelag_model: ModelPack, timelag_out_scaler,
                   note_labels, allowed_range, allowed_range_rest):
    is_prob = timelag_model.prediction_type() == PredictionType.PROBABILISTIC
    lag = _denorm_and_mlpg(pred, timelag_out_scaler, timelag_model.config,
                           is_prob)
    return _clip_timelag(lag, note_labels, allowed_range, allowed_range_rest)


def predict_timelag(labels, timelag_model: ModelPack, timelag_in_scaler,
                    timelag_out_scaler, binary_dict, numeric_dict, spk=None,
                    pitch_indices=None, log_f0_conditioning: bool = True,
                    allowed_range=(-20, 20), allowed_range_rest=(-40, 40),
                    force_clip_input_features: bool = False,
                    frame_period: float = 5):
    """Note-level time-lags: (lag in 100 ns units, lag in frames)."""
    hts_frame_shift = int(frame_period * 1e4)
    if pitch_indices is None:
        pitch_indices = hts.get_pitch_indices(binary_dict, numeric_dict)
    note_labels = _note_labels(labels, hts_frame_shift)
    feats = _timing_inputs(note_labels, binary_dict, numeric_dict,
                           timelag_in_scaler, pitch_indices,
                           log_f0_conditioning, force_clip_input_features,
                           hts_frame_shift)
    lag = _lag_from_pred(timelag_model.inference(feats, spks=spk),
                         timelag_model, timelag_out_scaler, note_labels,
                         allowed_range, allowed_range_rest)
    return lag * hts_frame_shift, lag


def predict_duration(labels, duration_model: ModelPack, duration_in_scaler,
                     duration_out_scaler, binary_dict, numeric_dict, spk=None,
                     pitch_indices=None, log_f0_conditioning: bool = True,
                     force_clip_input_features: bool = False,
                     frame_period: float = 5):
    """Phone durations; MDN models give ``(mu, sigma_sq)``."""
    hts_frame_shift = int(frame_period * 1e4)
    if pitch_indices is None:
        pitch_indices = hts.get_pitch_indices(binary_dict, numeric_dict)
    feats = _timing_inputs(labels, binary_dict, numeric_dict,
                           duration_in_scaler, pitch_indices,
                           log_f0_conditioning, force_clip_input_features,
                           hts_frame_shift)
    return _denorm_duration_pred(duration_model.inference(feats, spks=spk),
                                 duration_model, duration_out_scaler)


def predict_timing(labels, binary_dict, numeric_dict,
                   timelag_model: ModelPack, timelag_in_scaler,
                   timelag_out_scaler, duration_model: ModelPack,
                   duration_in_scaler, duration_out_scaler, spk=None,
                   log_f0_conditioning: bool = True, allowed_range=(-20, 20),
                   allowed_range_rest=(-40, 40),
                   force_clip_input_features: bool = True,
                   force_clip_input_features_duration: bool = None,
                   frame_period: float = 5):
    """predict_timelag + predict_duration + postprocess_duration: (duration-
    modified labels, lag in frames, cumulative normalized durations).
    ``force_clip_input_features_duration`` defaults to the timelag flag."""
    hts_frame_shift = int(frame_period * 1e4)
    labels.frame_shift = hts_frame_shift
    pitch_indices = hts.get_pitch_indices(binary_dict, numeric_dict)
    lag, lag_frames = predict_timelag(
        labels, timelag_model, timelag_in_scaler, timelag_out_scaler,
        binary_dict, numeric_dict, spk=spk, pitch_indices=pitch_indices,
        log_f0_conditioning=log_f0_conditioning, allowed_range=allowed_range,
        allowed_range_rest=allowed_range_rest,
        force_clip_input_features=force_clip_input_features,
        frame_period=frame_period)
    durations = predict_duration(
        labels, duration_model, duration_in_scaler, duration_out_scaler,
        binary_dict, numeric_dict, spk=spk, pitch_indices=pitch_indices,
        log_f0_conditioning=log_f0_conditioning,
        force_clip_input_features=(
            force_clip_input_features
            if force_clip_input_features_duration is None
            else force_clip_input_features_duration),
        frame_period=frame_period)
    labels_out, d_norms = postprocess_duration(labels, durations, lag,
                                               frame_period)
    return labels_out, lag_frames, d_norms


def predict_timing_batch(labels_list, binary_dict, numeric_dict,
                         timelag_model: ModelPack, timelag_in_scaler,
                         timelag_out_scaler, duration_model: ModelPack,
                         duration_in_scaler, duration_out_scaler,
                         log_f0_conditioning: bool = True,
                         allowed_range=(-20, 20),
                         allowed_range_rest=(-40, 40),
                         force_clip_input_features: bool = True,
                         force_clip_input_features_duration: bool = None,
                         frame_period: float = 5):
    """Timing of N independent tracks: each timing model runs once over an
    (N, T, D) batch.  Returns the duration-modified labels of each."""
    hts_frame_shift = int(frame_period * 1e4)
    pitch_indices = hts.get_pitch_indices(binary_dict, numeric_dict)
    if force_clip_input_features_duration is None:
        force_clip_input_features_duration = force_clip_input_features
    note_labels_list, note_feats, phone_feats = [], [], []
    for labels in labels_list:
        note_labels = _note_labels(labels, hts_frame_shift)
        note_labels_list.append(note_labels)
        note_feats.append(_timing_inputs(
            note_labels, binary_dict, numeric_dict, timelag_in_scaler,
            pitch_indices, log_f0_conditioning, force_clip_input_features,
            hts_frame_shift))
        phone_feats.append(_timing_inputs(
            labels, binary_dict, numeric_dict, duration_in_scaler,
            pitch_indices, log_f0_conditioning,
            force_clip_input_features_duration, hts_frame_shift))
    lag_future = timelag_model.inference_batch(note_feats, block=False)
    dur_future = duration_model.inference_batch(phone_feats, block=False)
    lag_preds, dur_preds = lag_future(), dur_future()
    outs = []
    for labels, note_labels, lag_pred, dur_pred in zip(
            labels_list, note_labels_list, lag_preds, dur_preds):
        lag = _lag_from_pred(lag_pred, timelag_model, timelag_out_scaler,
                             note_labels, allowed_range, allowed_range_rest)
        durations = _denorm_duration_pred(dur_pred, duration_model,
                                          duration_out_scaler)
        outs.append(postprocess_duration(labels, durations,
                                         lag * hts_frame_shift,
                                         frame_period)[0])
    return outs


# ---------------------------------------------------------------- acoustic
def _is_probabilistic(model: ModelPack) -> bool:
    return model.prediction_type() in (PredictionType.PROBABILISTIC,
                                       PredictionType.MULTISTREAM_HYBRID)


def predict_acoustic(labels, acoustic_model: ModelPack, acoustic_in_scaler,
                     acoustic_out_scaler, binary_dict, numeric_dict,
                     subphone_features: str = "coarse_coding",
                     pitch_indices=None, log_f0_conditioning: bool = True,
                     force_clip_input_features: bool = False,
                     frame_period: float = 5, f0_shift_in_cent: float = 0,
                     spk=None):
    """Denormalized acoustic features (T, D) on the host, with MLPG where
    delta features are modeled; the model runs on its pack's device."""
    hts_frame_shift = int(frame_period * 1e4)
    if pitch_indices is None:
        pitch_indices = hts.get_pitch_indices(binary_dict, numeric_dict)
    feats = _prepare_linguistic_features(
        labels, binary_dict, numeric_dict, acoustic_in_scaler, pitch_indices,
        True, subphone_features, log_f0_conditioning,
        force_clip_input_features, hts_frame_shift, f0_shift_in_cent)
    pred = acoustic_model.inference(feats, spks=spk)
    return _denorm_and_mlpg(pred, acoustic_out_scaler, acoustic_model.config,
                            _is_probabilistic(acoustic_model))


def correct_vuv_by_phone(vuv, binary_dict, linguistic_features):
    """Force V/UV from the question set's C-VUV_Voiced / C-VUV_Unvoiced
    and silence (sil, pau, br) flags."""
    vuv = vuv.copy()
    voiced_idx = -1
    unvoiced_indices, sil_indices = [], []
    for k, (name, _) in binary_dict.items():
        if "C-VUV_Voiced" in name and voiced_idx < 0:
            voiced_idx = k
        if "C-VUV_Unvoiced" in name:
            unvoiced_indices.append(k)
        if ("C-Phone_sil" in name or "C-Phone_pau" in name
                or "C-Phone_br" in name):
            sil_indices.append(k)
    if voiced_idx > 0:
        vuv[linguistic_features[:, voiced_idx: voiced_idx + 1] > 0] = 1.0
    for idx in unvoiced_indices + sil_indices:
        vuv[linguistic_features[:, idx: idx + 1] > 0] = 0.0
    return vuv


def _nonrest_frame_soft_mask(binary_dict, numeric_dict, linguistic_features,
                             win_length: int = 200,
                             duration_threshold: float = 1.0):
    """(T, 1) soft mask: about 1 on non-rest frames, about 0 on sil/pau
    segments longer than ``duration_threshold`` seconds, smoothed by a
    ``win_length``-frame moving average; frames with a note stay 1."""
    from scipy.signal import convolve

    mask = np.ones(len(linguistic_features))
    sil_indices = [k for k, (name, _) in binary_dict.items()
                   if "C-Phone_sil" in name or "C-Phone_pau" in name]
    if not sil_indices:
        return mask.reshape(-1, 1)
    note_dur_idx = next((k for k, (name, _) in numeric_dict.items()
                         if "e7" in name), None)
    if note_dur_idx is None:
        return mask.reshape(-1, 1)
    dur_in_sec = linguistic_features[:, len(binary_dict) + note_dur_idx] * 0.01
    for idx in sil_indices:
        mask[(linguistic_features[:, idx] > 0)
             & (dur_in_sec > duration_threshold)] = 0
    mask = convolve(mask, np.ones(win_length) / win_length, mode="same")
    pitch_idx = hts.get_pitch_index(binary_dict, numeric_dict)
    mask[linguistic_features[:, pitch_idx] > 0] = 1.0
    return mask.reshape(-1, 1)


def gen_spsvs_static_features(labels, acoustic_features: np.ndarray,
                              binary_dict, numeric_dict, stream_sizes,
                              has_dynamic_features, pitch_idx=None,
                              num_windows: int = 3, frame_period: float = 5,
                              relative_f0: bool = True,
                              vibrato_scale: float = 1.0,
                              vuv_threshold: float = 0.3,
                              force_fix_vuv: bool = True,
                              linguistic_features=None):
    """Static streams -> (mgc, lf0, vuv, bap): V/UV fixes by phone, the
    score lf0 added back under relative F0, the vibrato streams applied,
    unvoiced frames' lf0 filled by interpolation.  A fifth stream is a
    vibrato difference in Hz added to F0 (times ``vibrato_scale``); a fifth
    and sixth are the sine vibrato's (amplitude, rate) and its flags, the
    parameters zeroed where the flag is below 0.5, then
    ``ops/pitch.gen_sine_vibrato``.  ``linguistic_features`` (raw frame
    features) may be passed to skip recomputing them."""
    hts_frame_shift = int(frame_period * 1e4)
    if pitch_idx is None:
        pitch_idx = hts.get_pitch_index(binary_dict, numeric_dict)
    static_sizes = (get_static_stream_sizes(stream_sizes,
                                            has_dynamic_features, num_windows)
                    if np.any(has_dynamic_features) else stream_sizes)
    streams = split_streams(acoustic_features.copy(), list(static_sizes))
    if len(streams) not in (4, 5, 6):
        raise RuntimeError(f"unsupported number of streams: {len(streams)}")
    mgc, target_f0, vuv, bap = streams[:4]
    vib = streams[4] if len(streams) > 4 else None
    vib_flags = streams[5] if len(streams) > 5 else None
    if linguistic_features is None:
        linguistic_features = fe.linguistic_features(
            labels, binary_dict, numeric_dict, add_frame_features=True,
            frame_shift=hts_frame_shift)
    n = min(len(linguistic_features), len(mgc))
    linguistic_features = linguistic_features[:n]
    mgc, target_f0, vuv, bap = mgc[:n], target_f0[:n], vuv[:n], bap[:n]
    vib = vib[:n] if vib is not None else None
    vib_flags = vib_flags[:n] if vib_flags is not None else None
    if force_fix_vuv:
        vuv = correct_vuv_by_phone(vuv, binary_dict, linguistic_features)
    if relative_f0:
        f0_score = midi_to_hz(linguistic_features, pitch_idx, False)[:, None]
        lf0_score = f0_score.copy()
        nz = np.nonzero(lf0_score)
        lf0_score[nz] = np.log(f0_score[nz])
        f0 = target_f0 + interp1d(lf0_score)
    else:
        f0 = target_f0.copy()
    f0[vuv < vuv_threshold] = 0
    f0[np.nonzero(f0)] = np.exp(f0[np.nonzero(f0)])
    if vib is not None:
        if vib_flags is not None:
            off = vib_flags.flatten() < 0.5
            m_a, m_f = vib[:, 0].copy(), vib[:, 1].copy()
            m_a[off] = 0
            m_f[off] = 0
            sr_f0 = int(1 / (frame_period * 0.001))
            f0 = gen_sine_vibrato(f0.flatten(), sr_f0, m_a, m_f,
                                  vibrato_scale)
        else:
            f0 = f0.flatten() + vibrato_scale * vib.flatten()
    lf0 = f0.copy()
    lf0[np.nonzero(lf0)] = np.log(f0[np.nonzero(lf0)])
    lf0 = interp1d(lf0)
    lf0 = lf0[:, None] if lf0.ndim == 1 else lf0
    vuv = vuv[:, None] if vuv.ndim == 1 else vuv
    return mgc, lf0, vuv, bap


def _slaney_mel_frequencies(n_mels: int, fmin: float,
                            fmax: float) -> np.ndarray:
    """``n_mels`` band centres from ``fmin`` to ``fmax`` on the Slaney mel
    scale (linear below 1 kHz, logarithmic above), as
    ``librosa.mel_frequencies`` gives them; the melf0 GV offset reads
    them."""
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(
            f >= min_log_hz,
            min_log_mel + np.log(np.maximum(f, 1e-12) / min_log_hz) / logstep,
            f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def melf0_gv_offset(sample_rate: int) -> int:
    """The mel bands the GV postfilter leaves as they are: those up to
    the first Slaney band above 1200 Hz, which carry F0."""
    return int(np.argmax(
        _slaney_mel_frequencies(80, 63.0, sample_rate / 2) > 1200.0))


def postprocess_acoustic(acoustic_features: np.ndarray,
                         duration_modified_labels, binary_dict, numeric_dict,
                         acoustic_config, acoustic_out_static_scaler,
                         postfilter_model=None, postfilter_out_scaler=None,
                         sample_rate: int = 48000, frame_period: float = 5,
                         relative_f0: bool = False,
                         feature_type: str = "world",
                         post_filter_type: str = "gv",
                         trajectory_smoothing: bool = True,
                         trajectory_smoothing_cutoff: float = 50,
                         trajectory_smoothing_cutoff_f0: float = 20,
                         vuv_threshold: float = 0.5,
                         f0_shift_in_cent: float = 0,
                         fill_silence_to_rest: bool = False,
                         vibrato_scale: float = 1.0,
                         force_fix_vuv: bool = False,
                         linguistic_features=None):
    """Denormalized acoustic features -> WORLD streams (mgc, lf0, vuv, bap),
    or with ``feature_type="melf0"`` (mel, lf0, vuv), on the host, in the
    JAX package's order: the GV postfilter over note frames
    (``post_filter_type`` ``"gv"``, and for WORLD features ``"nnsvs"``
    before the learned postfilter; ``"none"``, ``"off"`` and None skip
    it; mel bands below :func:`melf0_gv_offset` and mgc dims 0-1 are left
    as they are); the merlin postfilter (``"merlin"``, WORLD only:
    mel-cepstrum dims from 2 on sharpened by 1.4, the spectral energy
    restored through c0); the learned postfilter (``"nnsvs"`` with a
    ``postfilter_model``, a ``ModelPack``, on the features normalized by
    ``postfilter_out_scaler``); then stream reconstruction (the mel
    streams split [80, 1, 1]), the long-rest crossfade (mel toward -5.5),
    the F0 shift and zero-phase trajectory smoothing.
    ``linguistic_features`` (raw frame features of the labels) may be
    passed to skip recomputing them."""
    if feature_type not in ("world", "melf0"):
        raise ValueError(f"unknown feature type: {feature_type}")
    world = feature_type == "world"
    hts_frame_shift = int(frame_period * 1e4)
    static_sizes = get_static_stream_sizes(
        acoustic_config.stream_sizes, acoustic_config.has_dynamic_features,
        acoustic_config.num_windows)
    mgc_end = int(static_sizes[0])
    if linguistic_features is None:
        linguistic_features = fe.linguistic_features(
            duration_modified_labels, binary_dict, numeric_dict,
            add_frame_features=True, frame_shift=hts_frame_shift)
    acoustic_features = np.asarray(acoustic_features).copy()
    if post_filter_type == "gv" or (post_filter_type == "nnsvs" and world):
        idx = hts.get_note_frame_indices(binary_dict, numeric_dict,
                                         linguistic_features)
        idx = idx[idx < len(acoustic_features)]
        acoustic_features[:, :mgc_end] = variance_scaling(
            np.asarray(acoustic_out_static_scaler.var_).reshape(-1)[:mgc_end],
            acoustic_features[:, :mgc_end],
            offset=2 if world else melf0_gv_offset(sample_rate),
            note_frame_indices=idx)
    if post_filter_type == "merlin" and world:
        mgc = acoustic_features[:, :mgc_end]
        weights = np.ones(mgc_end)
        weights[2:] = 1.4
        mgc_w = mgc * weights
        alpha = mcepalpha(sample_rate)
        fftlen = get_cheaptrick_fft_size(sample_rate)
        e1 = np.sum(mc2sp(mgc, alpha, fftlen), axis=-1)
        e2 = np.sum(mc2sp(mgc_w, alpha, fftlen), axis=-1)
        mgc_w[:, 0] += 0.5 * np.log(np.maximum(e1, 1e-16)
                                    / np.maximum(e2, 1e-16))
        acoustic_features[:, :mgc_end] = mgc_w
    if post_filter_type == "nnsvs" and postfilter_model is not None:
        normed = np.asarray(postfilter_out_scaler.transform(acoustic_features))
        out = postfilter_model.inference(normed.astype(np.float32))
        acoustic_features = np.asarray(
            postfilter_out_scaler.inverse_transform(out))
    if not world:
        mel, lf0, vuv = split_streams(acoustic_features, [80, 1, 1])
        if fill_silence_to_rest:
            mask = _nonrest_frame_soft_mask(binary_dict, numeric_dict,
                                            linguistic_features)
            mel = mel * mask + (1 - mask) * (-5.5)
        if f0_shift_in_cent != 0:
            lf0 = lf0 + f0_shift_in_cent * np.log(2) / 1200
        if trajectory_smoothing:
            lf0, (mel,) = _smooth(lf0, [mel], frame_period,
                                  trajectory_smoothing_cutoff,
                                  trajectory_smoothing_cutoff_f0)
        return mel, lf0, vuv
    mgc, lf0, vuv, bap = gen_spsvs_static_features(
        duration_modified_labels, acoustic_features, binary_dict,
        numeric_dict, acoustic_config.stream_sizes,
        acoustic_config.has_dynamic_features,
        pitch_idx=hts.get_pitch_index(binary_dict, numeric_dict),
        num_windows=acoustic_config.num_windows, frame_period=frame_period,
        relative_f0=relative_f0, vibrato_scale=vibrato_scale,
        vuv_threshold=vuv_threshold, force_fix_vuv=force_fix_vuv,
        linguistic_features=linguistic_features)
    if fill_silence_to_rest:
        mask = _nonrest_frame_soft_mask(binary_dict, numeric_dict,
                                        linguistic_features)
        mgc_sil = np.zeros((1, mgc.shape[1]))
        mgc_sil[0, :3] = (-23.3, 0.0679, 0.00640)
        mgc_sil[0, 3:] = 1e-3
        mgc = mgc * mask + (1 - mask) * mgc_sil
        bap = bap * mask + (1 - mask) * 1e-11
    if f0_shift_in_cent != 0:
        lf0 = lf0 + f0_shift_in_cent * np.log(2) / 1200
    if trajectory_smoothing:
        lf0, (mgc, bap) = _smooth(lf0, [mgc, bap], frame_period,
                                  trajectory_smoothing_cutoff,
                                  trajectory_smoothing_cutoff_f0)
    if bap.shape[-1] <= 5:
        bap = np.clip(bap, -60, 0)
    return mgc, lf0, vuv, bap


def _smooth(lf0, streams, frame_period, cutoff, cutoff_f0):
    """Zero-phase low-pass of lf0 (in place, at ``cutoff_f0``) and of each
    spectral stream (at ``cutoff``) over time."""
    modfs = int(1 / (frame_period * 0.001))
    lf0[:, 0] = lowpass_filter(lf0[:, 0], modfs, cutoff=cutoff_f0)
    return lf0, [np.ascontiguousarray(lowpass_filter(
        a, modfs, cutoff=cutoff, axis=0)) for a in streams]


# ---------------------------------------------------------------- waveform
def pad_streams(streams, T_pad: int):
    """(mgc, lf0, vuv, bap) of T frames -> float32 arrays of T_pad frames:
    vuv padded with zeros (unvoiced), the others with their last frame."""
    mgc, lf0, vuv, bap = streams
    pad = T_pad - len(lf0)
    return [np.pad(np.asarray(a, np.float32), ((0, pad), (0, 0)),
                   **({} if k == 2 else {"mode": "edge"}))
            for k, a in enumerate((mgc, lf0, vuv, bap))]


def gen_world_params(mgc, lf0, vuv, bap, sample_rate: int,
                     vuv_threshold: float = 0.3,
                     use_world_codec: bool = False):
    """(mgc, lf0, vuv, bap) -> WORLD parameters on the host: f0 (T,) Hz,
    float64; the power envelope (T, fft//2+1), decoded from coded mgc
    (``use_world_codec``) or by ``mc2sp`` from mel-cepstrum; and the
    aperiodicity (T, fft//2+1), decoded from band codes or by ``mc2sp``
    from mel-cepstral aperiodicity (bap dim > 5), 1 on unvoiced frames and
    clipped to [0, 1]."""
    fftlen = get_cheaptrick_fft_size(sample_rate)
    if use_world_codec:
        spectrogram = decode_spectral_envelope_np(
            np.ascontiguousarray(mgc).astype(np.float64), sample_rate, fftlen)
    else:
        spectrogram = mc2sp(np.ascontiguousarray(mgc),
                            mcepalpha(sample_rate), fftlen)
    if bap.shape[-1] > 5:
        aperiodicity = mc2sp(np.ascontiguousarray(bap),
                             mcepalpha(sample_rate), fftlen)
    else:
        aperiodicity = decode_aperiodicity(
            torch.from_numpy(np.ascontiguousarray(bap).astype(np.float64)),
            sample_rate, fftlen).numpy()
    aperiodicity[vuv.reshape(-1) < vuv_threshold, 0] = 1.0
    aperiodicity = np.clip(aperiodicity, 0.0, 1.0)
    f0 = lf0.copy()
    f0[np.nonzero(f0)] = np.exp(f0[np.nonzero(f0)])
    f0[vuv < vuv_threshold] = 0
    return f0.flatten().astype(np.float64), spectrogram, aperiodicity


def predict_waveform(multistream_features, vocoder=None,
                     vocoder_in_scaler=None, sample_rate: int = 48000,
                     frame_period: float = 5, use_world_codec: bool = True,
                     feature_type: str = "world", vocoder_type: str = "world",
                     vuv_threshold: float = 0.5, device="cuda", noise=None):
    """Host streams -> float waveform on the host: WORLD streams (mgc,
    lf0, vuv, bap), or with ``feature_type="melf0"`` (mel, lf0, vuv),
    which only the neural vocoders take (WORLD raises ValueError, as the
    JAX package does).

    ``"world"``: synthesized on ``device`` and padded to the frame bucket
    as in the JAX package (``noise``: (1, T_pad * hop) on ``device``, by
    default :func:`vocoder_noise` over the padded length).  Coded streams
    go through the coded-stream vocoder; uncoded features
    (``use_world_codec=False``) and mel-cepstral aperiodicity (bap dim >
    5) through :func:`gen_world_params` and ``synthesize``, padded as the
    JAX package pads them (f0 with 0, the envelope at its edge, the
    aperiodicity with 1).  No high-pass here: ``postprocess_waveform``
    applies the band-pass.

    ``"pwg"``: ``vocoder.inference`` on [mgc, lf0, binarized vuv, bap] or
    [mel, lf0, binarized vuv]; ``"usfgan"``: ``vocoder.inference(f0,
    aux)`` with F0 = exp(lf0) (0 on unvoiced frames when the vocoder's
    ``sine_f0_type`` is ``"f0"``) and aux the mel, or [mgc, bap] with bap
    round-tripped through the aperiodicity codec in float64 on the host,
    1 at the lowest bin of unvoiced frames; both through
    ``vocoder_in_scaler`` when given, unpadded, on the vocoder's device.
    Without a ``vocoder`` they raise ValueError."""
    if feature_type not in ("world", "melf0"):
        raise ValueError(f"unknown feature type: {feature_type}")
    if vocoder_type in ("pwg", "usfgan"):
        return _neural_waveform(multistream_features, feature_type, vocoder,
                                vocoder_in_scaler, sample_rate,
                                vocoder_type, vuv_threshold)
    if vocoder_type != "world":
        raise ValueError(f"unknown vocoder type: {vocoder_type}")
    if feature_type != "world":
        raise ValueError(
            f"invalid feature type for WORLD vocoder: {feature_type}")
    mgc, lf0, vuv, bap = multistream_features
    T = len(lf0)
    T_pad = _round_up(max(T, 1), FRAME_BUCKET)
    hop = int(sample_rate * frame_period / 1000)
    device = torch.device(device)
    if noise is None:
        noise = vocoder_noise(1, T_pad * hop, device)
    if use_world_codec and bap.shape[-1] <= 5:
        streams = [torch.from_numpy(a)[None].to(device)
                   for a in pad_streams((mgc, lf0, vuv, bap), T_pad)]
        wav = synthesize_from_streams(*streams, noise, sample_rate,
                                      frame_period,
                                      vuv_threshold=vuv_threshold)
    else:
        f0, sp, ap = gen_world_params(mgc, lf0, vuv, bap, sample_rate,
                                      vuv_threshold=vuv_threshold,
                                      use_world_codec=use_world_codec)
        pad = T_pad - T
        f0, sp, ap = (
            torch.from_numpy(a.astype(np.float32))[None].to(device)
            for a in (np.pad(f0, (0, pad)),
                      np.pad(sp, ((0, pad), (0, 0)), mode="edge"),
                      np.pad(ap, ((0, pad), (0, 0)), constant_values=1.0)))
        wav = synthesize(f0, sp, ap, noise, sample_rate, frame_period)
    return wav[0, : T * hop].cpu().numpy()


def _neural_waveform(streams, feature_type, vocoder, vocoder_in_scaler,
                     sample_rate, vocoder_type, vuv_threshold):
    if vocoder is None:
        raise ValueError(f"vocoder_type={vocoder_type!r} needs a packed "
                         "neural vocoder (vocoder_model.yaml); this engine "
                         "has none")
    world = feature_type == "world"
    if world:
        mgc, lf0, vuv, bap = streams
    else:
        mel, lf0, vuv = streams
    if vocoder_type == "pwg":
        vuv_bin = (vuv > vuv_threshold).astype(np.float32)
        feats = np.concatenate([mgc, lf0, vuv_bin, bap] if world
                               else [mel, lf0, vuv_bin], axis=-1)
    elif world:
        fftlen = get_cheaptrick_fft_size(sample_rate)
        ap = decode_aperiodicity(torch.from_numpy(
            np.ascontiguousarray(bap).astype(np.float64)), sample_rate,
            fftlen).numpy()
        ap[vuv.reshape(-1) < vuv_threshold, 0] = 1.0
        bap_fixed = code_aperiodicity(np.clip(ap, 0.0, 1.0),
                                      sample_rate).astype(np.float32)
        feats = np.concatenate([mgc, bap_fixed], axis=-1)
    else:
        feats = mel
    if vocoder_in_scaler is not None:
        feats = np.asarray(vocoder_in_scaler.transform(feats), np.float32)
    if vocoder_type == "pwg":
        return np.asarray(vocoder.inference(feats)).reshape(-1)
    f0 = np.exp(lf0)
    if getattr(vocoder, "sine_f0_type", "contf0") == "f0":
        f0[vuv < vuv_threshold] = 0
    return np.asarray(vocoder.inference(f0, feats)).reshape(-1)


def postprocess_waveform(wav: np.ndarray, sample_rate: int, dtype=np.int16,
                         peak_norm: bool = False, loudness_norm: bool = False,
                         target_loudness: float = -20.0,
                         skip_bandpass: bool = False):
    """Band-pass (skipped where the vocoder applied its high-pass), peak or
    RMS loudness normalization, a final peak normalization, then ``dtype``
    (int16 scaled by 32767)."""
    if not skip_bandpass:
        wav = np.asarray(bandpass_filter(wav, sample_rate))
    else:
        wav = np.asarray(wav, dtype=np.float64)
    if peak_norm:
        peak = np.max(np.abs(wav))
        if peak > 0:
            wav = wav / peak
    if loudness_norm:
        rms = np.sqrt(np.mean(wav ** 2))
        if rms > 0:
            wav = wav * 10 ** ((target_loudness - 20 * np.log10(rms)) / 20)
    peak = np.max(np.abs(wav))
    if peak > 0:
        wav = wav / peak
    if dtype in (np.int16, "int16"):
        return (wav * 32767.0).astype(np.int16)
    if dtype is not None:
        wav = wav.astype(dtype)
    return wav
