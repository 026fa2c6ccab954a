"""Dump predicted time-lags and durations for objective timing evaluation;
the port's copy of ``ensemble_svs_with_interactions_tpu/bin/
evaluate_timing.py``.

Writes per-utterance ``timelag/{utt}.npy`` / ``duration/{utt}.npy`` and
prints summary MAEs against the ground truth of the aligned labels; with
``--multitrack``, every ordered same-segment singer pair (main, sub)
predicts the main track's timing through the joint models, dumped as
``{spk_m}_{seg}_with_{spk_s}.npy``.  The models run on ``--device``
(``cuda`` unless ``--device cpu``).

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.evaluate_timing
       <model_dir> <score_label_dir> <align_label_dir> <out_dir>
       [--multitrack --spk-names a,b] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ensemble_svs_with_interactions_tpu_torch import gen, gen_multitrack
from ensemble_svs_with_interactions_tpu_torch.bin.synthesis_multitrack import (
    group_by_segment,
    ordered_pairs,
)
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS


def _truth(score, align, frame_period: float):
    """(note onset lags, phone durations) in frames of the aligned labels
    against the score."""
    note_indices = hts.get_note_indices(score)
    frame_shift = int(frame_period * 1e4)
    gt_lag = (
        np.asarray(align.start_times)[note_indices]
        - np.asarray(score.start_times)[note_indices]
    ) / frame_shift
    gt_dur = (
        np.asarray(align.end_times) - np.asarray(align.start_times)
    ) / frame_shift
    return gt_lag, gt_dur


def _maes(lag_frames, pred_dur, gt_lag, gt_dur):
    n = min(len(gt_lag), len(lag_frames))
    m = min(len(gt_dur), len(pred_dur))
    return (np.abs(lag_frames.reshape(-1)[:n] - gt_lag[:n]).mean(),
            np.abs(pred_dur.reshape(-1)[:m] - gt_dur[:m]).mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model_dir")
    ap.add_argument("score_label_dir")
    ap.add_argument("align_label_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--multitrack", action="store_true")
    ap.add_argument("--spk-names", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engine = SPSVS(args.model_dir, device=args.device)
    out_dir = Path(args.out_dir)
    (out_dir / "timelag").mkdir(parents=True, exist_ok=True)
    (out_dir / "duration").mkdir(parents=True, exist_ok=True)

    with torch.no_grad():
        if args.multitrack:
            return _main_multitrack(args, engine, out_dir)
        return _main(args, engine, out_dir)


def _main(args, engine, out_dir):
    lag_maes, dur_maes = [], []
    for score_path in sorted(Path(args.score_label_dir).glob("*.lab")):
        align_path = Path(args.align_label_dir) / score_path.name
        if not align_path.exists():
            continue
        score = hts.load(score_path)
        align = hts.load(align_path)

        # same per-phase clipping flags as synthesis
        lag, lag_frames = gen.predict_timelag(
            score.copy(),
            engine.timelag_model,
            engine.in_timelag_scaler,
            engine.out_timelag_scaler,
            engine.binary_dict,
            engine.numeric_dict,
            force_clip_input_features=engine._force_clip("timelag"),
            frame_period=engine.frame_period,
        )
        durations = gen.predict_duration(
            score.copy(),
            engine.duration_model,
            engine.in_duration_scaler,
            engine.out_duration_scaler,
            engine.binary_dict,
            engine.numeric_dict,
            force_clip_input_features=engine._force_clip("duration"),
            frame_period=engine.frame_period,
        )
        pred_dur = durations[0] if isinstance(durations, tuple) else durations

        utt = score_path.stem
        np.save(out_dir / "timelag" / f"{utt}.npy", lag_frames)
        np.save(out_dir / "duration" / f"{utt}.npy", pred_dur)
        lag_mae, dur_mae = _maes(lag_frames, pred_dur,
                                 *_truth(score, align, engine.frame_period))
        lag_maes.append(lag_mae)
        dur_maes.append(dur_mae)

    if lag_maes:
        print(
            f"timelag MAE: {np.mean(lag_maes):.2f} frames, "
            f"duration MAE: {np.mean(dur_maes):.2f} frames "
            f"({len(lag_maes)} utterances) -> {out_dir}"
        )
    return 0


def _main_multitrack(args, engine, out_dir):
    """Pairwise cross-conditioned timing dumps: every ordered same-segment
    singer pair (main, sub) predicts the MAIN track's timelag/duration
    through the joint models."""
    spk_names = [s for s in args.spk_names.split(",") if s]
    by_segment = group_by_segment(
        sorted(Path(args.score_label_dir).glob("*.lab")), spk_names)

    lag_maes, dur_maes, n = [], [], 0
    for seg, (spk_m, path_m), (spk_s, path_s) in ordered_pairs(by_segment):
        score_m = hts.load(path_m)
        score_s = hts.load(path_s)
        spks = (
            spk_names.index(spk_m) if spk_m in spk_names else 0,
            spk_names.index(spk_s) if spk_s in spk_names else 0,
        )
        _, lag_frames, _ = gen_multitrack.predict_timelag_multitrack(
            [score_m.copy(), score_s.copy()], spks,
            engine.timelag_model, engine.in_timelag_scaler,
            engine.out_timelag_scaler, engine.binary_dict,
            engine.numeric_dict,
            force_clip_input_features=engine._force_clip("timelag"),
            frame_period=engine.frame_period,
        )
        durations = gen_multitrack.predict_duration_multitrack(
            [score_m.copy(), score_s.copy()], spks,
            engine.duration_model, engine.in_duration_scaler,
            engine.out_duration_scaler, engine.binary_dict,
            engine.numeric_dict,
            force_clip_input_features=engine._force_clip("duration"),
            frame_period=engine.frame_period,
        )
        pred_dur = durations[0] if isinstance(durations, tuple) else durations
        name = f"{spk_m}_{seg}_with_{spk_s}"
        np.save(out_dir / "timelag" / f"{name}.npy", lag_frames)
        np.save(out_dir / "duration" / f"{name}.npy", pred_dur)

        align_path = Path(args.align_label_dir) / path_m.name
        if align_path.exists():
            lag_mae, dur_mae = _maes(
                lag_frames, pred_dur,
                *_truth(score_m, hts.load(align_path), engine.frame_period))
            lag_maes.append(lag_mae)
            dur_maes.append(dur_mae)
        n += 1
    if lag_maes:
        print(
            f"timelag MAE: {np.mean(lag_maes):.2f} frames, "
            f"duration MAE: {np.mean(dur_maes):.2f} frames "
            f"({n} pairs) -> {out_dir}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
