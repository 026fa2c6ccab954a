"""Cross-conditioned timing for an N-part ensemble: the counterpart of
``predict_timing_multitrack_batch`` in
``ensemble_svs_with_interactions_tpu/gen_multitrack.py``.

Track ``i`` is the main track of pair ``(i, pairs[i])``: the two tracks'
note-level (timelag) and phone-level (duration) features are merged onto a
common timeline, every pair runs through the joint model as one (N, T, D)
batch, and the main track's positions are taken back out.
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
        xs, masks = [], []
        for i in range(N):
            j = pairs[i]
            mx0, _, mask0, mx1, _, _ = merge_tracks_by_notes(
                feats[i], np.zeros((len(feats[i]), 1), np.float32), times[i],
                feats[j], np.zeros((len(feats[j]), 1), np.float32), times[j])
            xs.append(np.concatenate([mx0, mx1], axis=-1))
            masks.append(mask0)
        return xs, masks

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
