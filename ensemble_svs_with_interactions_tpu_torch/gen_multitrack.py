"""Cross-conditioned timing and acoustics: the counterpart of
``ensemble_svs_with_interactions_tpu/gen_multitrack.py``.

A pair is a main track conditioned on a sub track: the two tracks'
note-level (timelag) and phone-level (duration) features are merged onto a
common timeline, the joint model runs on ``concat(x_main, x_sub)``, and
the main track's positions are taken back out.  The per-pair functions
(``predict_timing_multitrack``, ``predict_acoustic_multitrack``) run one
pair at a time, as the recipe's synthesis stage does;
``predict_timing_multitrack_batch`` runs every pair of an N-part ensemble
(track ``i`` the main track of pair ``(i, pairs[i])``) as one (N, T, D)
batch.

As in the JAX package, the timelag functions set ``frame_shift`` on the
labels they are given and round them in place (``SPSVS``'s methods hand
them copies).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ensemble_svs_with_interactions_tpu_torch import gen
from ensemble_svs_with_interactions_tpu_torch.base import PredictionType
from ensemble_svs_with_interactions_tpu_torch.data.multitrack import (
    merge_tracks_by_notes,
)
from ensemble_svs_with_interactions_tpu_torch.io import hts


def _note_level_features(labels, binary_dict, numeric_dict, in_scaler,
                         pitch_indices, log_f0_conditioning, force_clip,
                         frame_shift):
    note_labels = labels[hts.get_note_indices(labels)]
    feats = gen._prepare_linguistic_features(
        note_labels, binary_dict, numeric_dict, in_scaler, pitch_indices,
        False, None, log_f0_conditioning, force_clip, frame_shift)
    return feats, np.asarray(note_labels.start_times), note_labels


def _merge_pair(feats0, times0, feats1, times1):
    """The pair's merged model input ``concat(x_main, x_sub)`` and the
    main track's presence mask on the merged timeline."""
    mx0, _, mask0, mx1, _, _ = merge_tracks_by_notes(
        feats0, np.zeros((len(feats0), 1), np.float32), times0,
        feats1, np.zeros((len(feats1), 1), np.float32), times1)
    return np.concatenate([mx0, mx1], axis=-1), mask0


def _merged_timing_inference(labels_list, spks_list, model: gen.ModelPack,
                             in_scaler, out_scaler, binary_dict, numeric_dict,
                             pitch_indices, log_f0_conditioning, force_clip,
                             frame_shift):
    """The note merge and the joint model's inference for one pair: (mu,
    sigma_sq or None, the main track's mask, its note labels), mu and
    sigma_sq over the main track's notes.  MLPG, where delta windows are
    modeled, runs over the merged timeline before the un-merge."""
    feats0, times0, note_labels0 = _note_level_features(
        labels_list[0], binary_dict, numeric_dict, in_scaler, pitch_indices,
        log_f0_conditioning, force_clip, frame_shift)
    feats1, times1, _ = _note_level_features(
        labels_list[1], binary_dict, numeric_dict, in_scaler, pitch_indices,
        log_f0_conditioning, force_clip, frame_shift)
    x, mask0 = _merge_pair(feats0, times0, feats1, times1)
    pred = model.inference(x, spks=([spks_list[0]], [spks_list[1]]))
    if model.prediction_type() == PredictionType.PROBABILISTIC:
        mu, sigma = pred
        if np.any(model.config.has_dynamic_features):
            out = gen._denorm_and_mlpg((mu, sigma), out_scaler, model.config,
                                       True)
            return out[mask0], None, mask0, note_labels0
        sigma_sq = np.maximum(
            np.asarray(sigma) ** 2 * np.asarray(out_scaler.var_), 1e-14)
        mu = np.asarray(out_scaler.inverse_transform(np.asarray(mu)))
        return mu[mask0], sigma_sq[mask0], mask0, note_labels0
    out = gen._denorm_and_mlpg(pred, out_scaler, model.config, False)
    return out[mask0], None, mask0, note_labels0


def predict_timelag_multitrack(
    labels_list, spks_list, timelag_model: gen.ModelPack, timelag_in_scaler,
    timelag_out_scaler, binary_dict, numeric_dict, pitch_indices=None,
    log_f0_conditioning: bool = True, allowed_range=(-20, 20),
    allowed_range_rest=(-40, 40), force_clip_input_features: bool = True,
    frame_period: float = 5,
):
    """The main track's note-level time-lags, conditioned on both tracks:
    (lag in 100 ns units, lag in frames, the main track's mask)."""
    hts_frame_shift = int(frame_period * 1e4)
    for labels in labels_list:
        labels.frame_shift = hts_frame_shift
        labels.round_()
    if pitch_indices is None:
        pitch_indices = hts.get_pitch_indices(binary_dict, numeric_dict)
    mu, _, mask0, note_labels = _merged_timing_inference(
        labels_list, spks_list, timelag_model, timelag_in_scaler,
        timelag_out_scaler, binary_dict, numeric_dict, pitch_indices,
        log_f0_conditioning, force_clip_input_features, hts_frame_shift)
    pred = gen._clip_timelag(mu, note_labels, allowed_range,
                             allowed_range_rest)
    return pred * hts_frame_shift, pred, mask0


def predict_duration_multitrack(
    labels_list, spks_list, duration_model: gen.ModelPack,
    duration_in_scaler, duration_out_scaler, binary_dict, numeric_dict,
    pitch_indices=None, log_f0_conditioning: bool = True,
    force_clip_input_features: bool = True, frame_period: float = 5,
):
    """The main track's phone durations from the joint two-track model
    (merged over phone start times); MDN models give ``(mu, sigma_sq)``."""
    hts_frame_shift = int(frame_period * 1e4)
    if pitch_indices is None:
        pitch_indices = hts.get_pitch_indices(binary_dict, numeric_dict)
    feats = [gen._prepare_linguistic_features(
        labels, binary_dict, numeric_dict, duration_in_scaler, pitch_indices,
        False, None, log_f0_conditioning, force_clip_input_features,
        hts_frame_shift) for labels in labels_list[:2]]
    x, mask0 = _merge_pair(feats[0], np.asarray(labels_list[0].start_times),
                           feats[1], np.asarray(labels_list[1].start_times))
    pred = duration_model.inference(x, spks=([spks_list[0]], [spks_list[1]]))
    if duration_model.prediction_type() == PredictionType.PROBABILISTIC:
        mu, sigma = pred
        sigma_sq = np.maximum(np.asarray(sigma) ** 2
                              * np.asarray(duration_out_scaler.var_), 1e-14)
        mu = np.asarray(duration_out_scaler.inverse_transform(np.asarray(mu)))
        return mu[mask0], sigma_sq[mask0]
    out = np.asarray(duration_out_scaler.inverse_transform(np.asarray(pred)))
    out = out[mask0]
    out[out <= 0] = 1
    return np.round(out)


def predict_timing_multitrack_batch(
    labels_list, spk_ids, pairs, binary_dict, numeric_dict,
    timelag_model: gen.ModelPack, timelag_in_scaler, timelag_out_scaler,
    duration_model: gen.ModelPack, duration_in_scaler, duration_out_scaler,
    log_f0_conditioning: bool = True, allowed_range=(-20, 20),
    allowed_range_rest=(-40, 40), force_clip_input_features: bool = True,
    force_clip_input_features_duration: bool = None, frame_period: float = 5,
):
    """Returns one duration-modified label sequence per track."""
    hts_frame_shift = int(frame_period * 1e4)
    pitch_indices = hts.get_pitch_indices(binary_dict, numeric_dict)
    N = len(labels_list)
    force_clip_duration = (force_clip_input_features
                           if force_clip_input_features_duration is None
                           else force_clip_input_features_duration)

    def _prep_track(labels):
        labels.frame_shift = hts_frame_shift
        labels.round_()
        nl = labels[hts.get_note_indices(labels)]
        tl_feats = gen._prepare_linguistic_features(
            nl, binary_dict, numeric_dict, timelag_in_scaler, pitch_indices,
            False, None, log_f0_conditioning, force_clip_input_features,
            hts_frame_shift)
        du_feats = gen._prepare_linguistic_features(
            labels, binary_dict, numeric_dict, duration_in_scaler,
            pitch_indices, False, None, log_f0_conditioning,
            force_clip_duration, hts_frame_shift)
        return (nl, tl_feats, np.asarray(nl.start_times), du_feats,
                np.asarray(labels.start_times))

    with ThreadPoolExecutor(max_workers=N) as ex:
        prepped = list(ex.map(_prep_track, labels_list))
    note_labels = [p[0] for p in prepped]

    def _merged_pairs(feats, times):
        merged = [_merge_pair(feats[i], times[i], feats[pairs[i]],
                              times[pairs[i]]) for i in range(N)]
        return [m[0] for m in merged], [m[1] for m in merged]

    spks = ([spk_ids[i] for i in range(N)],
            [spk_ids[pairs[i]] for i in range(N)])
    tl_xs, tl_masks = _merged_pairs([p[1] for p in prepped],
                                    [p[2] for p in prepped])
    tl_future = timelag_model.inference_batch(tl_xs, spks=spks, block=False)
    du_xs, du_masks = _merged_pairs([p[3] for p in prepped],
                                    [p[4] for p in prepped])
    du_future = duration_model.inference_batch(du_xs, spks=spks, block=False)
    tl_preds = tl_future()
    du_preds = du_future()

    tl_prob = timelag_model.prediction_type() == PredictionType.PROBABILISTIC
    outs = []
    for i in range(N):
        # MLPG (when delta windows are modeled) runs over the MERGED
        # timeline before un-merging
        lag = gen._denorm_and_mlpg(tl_preds[i], timelag_out_scaler,
                                   timelag_model.config, tl_prob)
        lag = gen._clip_timelag(lag[tl_masks[i]], note_labels[i],
                                allowed_range, allowed_range_rest)
        lag = lag * hts_frame_shift
        durations = gen._denorm_duration_pred(du_preds[i], duration_model,
                                              duration_out_scaler)
        if isinstance(durations, tuple):
            durations = (durations[0][du_masks[i]], durations[1][du_masks[i]])
        else:
            durations = durations[du_masks[i]]
        outs.append(gen.postprocess_duration(labels_list[i], durations, lag,
                                             frame_period)[0])
    return outs


def predict_timing_multitrack(
    labels_list, spks_list, binary_dict, numeric_dict,
    timelag_model: gen.ModelPack, timelag_in_scaler, timelag_out_scaler,
    duration_model: gen.ModelPack, duration_in_scaler, duration_out_scaler,
    log_f0_conditioning: bool = True, allowed_range=(-20, 20),
    allowed_range_rest=(-40, 40), force_clip_input_features: bool = True,
    force_clip_input_features_duration: bool = None, frame_period: float = 5,
):
    """Timelag, durations and duration normalization of the main track
    (``labels_list[0]``) of one pair: (duration-modified labels, lag in
    frames, cumulative normalized durations, the main track's note mask).
    ``force_clip_input_features_duration`` defaults to the timelag flag."""
    hts_frame_shift = int(frame_period * 1e4)
    for labels in labels_list:
        labels.frame_shift = hts_frame_shift
    pitch_indices = hts.get_pitch_indices(binary_dict, numeric_dict)
    lag, lag_frames, mask = predict_timelag_multitrack(
        labels_list, spks_list, timelag_model, timelag_in_scaler,
        timelag_out_scaler, binary_dict, numeric_dict,
        pitch_indices=pitch_indices, log_f0_conditioning=log_f0_conditioning,
        allowed_range=allowed_range, allowed_range_rest=allowed_range_rest,
        force_clip_input_features=force_clip_input_features,
        frame_period=frame_period)
    durations = predict_duration_multitrack(
        labels_list, spks_list, duration_model, duration_in_scaler,
        duration_out_scaler, binary_dict, numeric_dict,
        pitch_indices=pitch_indices, log_f0_conditioning=log_f0_conditioning,
        force_clip_input_features=(
            force_clip_input_features
            if force_clip_input_features_duration is None
            else force_clip_input_features_duration),
        frame_period=frame_period)
    labels_out, d_norms = gen.postprocess_duration(labels_list[0], durations,
                                                   lag, frame_period)
    return labels_out, lag_frames, d_norms, mask


def predict_acoustic_multitrack(
    labels_list, spks_list, acoustic_model: gen.ModelPack, acoustic_in_scaler,
    acoustic_out_scaler, binary_dict, numeric_dict,
    subphone_features: str = "coarse_coding", pitch_indices=None,
    log_f0_conditioning: bool = True, force_clip_input_features: bool = True,
    frame_period: float = 5, f0_shift_in_cent: float = 0,
):
    """Denormalized frame-level acoustic features (T, D) of the main track
    of one pair, conditioned on the sub track: both tracks' features are
    padded with zeros to the longer one's frame count, which the model
    takes as the length, and the output is cut to the main track's.  A
    module with ``inference_main`` computes the main track's outputs
    only."""
    hts_frame_shift = int(frame_period * 1e4)
    if pitch_indices is None:
        pitch_indices = hts.get_pitch_indices(binary_dict, numeric_dict)
    feats = [gen._prepare_linguistic_features(
        labels, binary_dict, numeric_dict, acoustic_in_scaler, pitch_indices,
        True, subphone_features, log_f0_conditioning,
        force_clip_input_features, hts_frame_shift, f0_shift_in_cent)
        for labels in labels_list]
    T = max(len(f) for f in feats)
    x0, x1 = (np.pad(f, ((0, T - len(f)), (0, 0))) for f in feats[:2])
    use_main = hasattr(acoustic_model.module, "inference_main")
    pred = acoustic_model.inference(
        x0, spks=([spks_list[0]], [spks_list[1]]), x_sub=x1,
        method="inference_main" if use_main else "inference")
    if (not use_main and isinstance(pred, tuple)
            and acoustic_model.prediction_type()
            != PredictionType.PROBABILISTIC):
        # the full multitrack inference gives (out_main, out_sub)
        pred = pred[0]
    n = len(feats[0])
    if isinstance(pred, tuple):
        pred = tuple(np.asarray(p)[:n] for p in pred)
    else:
        pred = np.asarray(pred)[:n]
    return gen._denorm_and_mlpg(pred, acoustic_out_scaler,
                                acoustic_model.config,
                                gen._is_probabilistic(acoustic_model))
