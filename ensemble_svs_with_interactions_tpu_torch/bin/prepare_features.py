"""Feature extraction CLI (the recipe's stage 1): labels and wavs ->
in_/out_ feature dumps; the port's copy of
``ensemble_svs_with_interactions_tpu/bin/prepare_features.py``.

Extracts timelag/duration/acoustic input and output features per
utterance with a process pool (``n_jobs``), writing
``{out_dir}/{in,out}_{phase}/{utt}-feats.npy`` (+ ``{utt}-wave.npy`` and
postfilter targets for the acoustic phase, and ``-times.npy`` note times
with ``save_note_times``).  The workers are forks of the caller, so the
caller's ``ESVS_DISABLE_NATIVE`` and ``ESVS_SPECTRAL_CODEC_BASIS`` choose
their path.

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.prepare_features
       config.yaml [key=value ...]

Config keys: utt_list, out_dir, question_path,
  timelag.{label_phone_score_dir,label_phone_align_dir},
  duration.{label_dir}, acoustic.{wav_dir,label_dir,params...}
"""

from __future__ import annotations

import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.data.data_source import (
    DurationFeatureSource,
    MultiTrackMusicalLinguisticSource,
    MusicalLinguisticSource,
    TimeLagFeatureSource,
    WORLDAcousticSource,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    load_config,
    merge,
    parse_overrides,
)


def _save(out_dir: Path, utt_id: str, feats: np.ndarray, suffix="-feats.npy"):
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / f"{utt_id}{suffix}", feats)


def _utt_id(path) -> str:
    return Path(path).stem


def _process_utt(args):
    (
        idx,
        timelag_files,
        duration_files,
        acoustic_files,
        sources,
        out_dir,
        save_times,
    ) = args
    timelag_src, duration_src, linguistic_phone_src, linguistic_frame_src, acoustic_src = sources
    out_dir = Path(out_dir)

    score_path, align_path = timelag_files
    utt = _utt_id(align_path)

    # timelag: in = phone-level linguistic on score labels (+times for sync)
    if save_times:
        feats, times = linguistic_phone_src.collect_features(score_path)
        _save(out_dir / "in_timelag", utt, feats)
        _save(out_dir / "in_timelag", utt, times, suffix="-times.npy")
    else:
        feats = linguistic_phone_src.collect_features(score_path)
        _save(out_dir / "in_timelag", utt, feats)
    _save(
        out_dir / "out_timelag",
        utt,
        timelag_src.collect_features(score_path, align_path),
    )

    # duration: in = phone-level linguistic on aligned labels
    dur_path = duration_files
    if save_times:
        feats, times = linguistic_phone_src.collect_features(dur_path)
        _save(out_dir / "in_duration", utt, feats)
        _save(out_dir / "in_duration", utt, times, suffix="-times.npy")
    else:
        _save(
            out_dir / "in_duration",
            utt,
            linguistic_phone_src.collect_features(dur_path),
        )
    _save(out_dir / "out_duration", utt, duration_src.collect_features(dur_path))

    # acoustic: in = frame-level linguistic, out = WORLD features
    wav_path, label_path = acoustic_files
    if save_times:
        feats, times = linguistic_frame_src.collect_features(label_path)
        _save(out_dir / "in_acoustic", utt, feats)
        _save(out_dir / "in_acoustic", utt, times, suffix="-times.npy")
    else:
        _save(
            out_dir / "in_acoustic",
            utt,
            linguistic_frame_src.collect_features(label_path),
        )
    features, wave, pf_features = acoustic_src.collect_features(wav_path, label_path)
    if features is None:
        return utt, False
    _save(out_dir / "out_acoustic", utt, features)
    _save(out_dir / "out_acoustic", utt, wave, suffix="-wave.npy")
    _save(out_dir / "out_postfilter", utt, pf_features)
    return utt, True


def run(config):
    out_dir = Path(config.out_dir)
    save_times = bool(config.get("save_note_times", False))
    ling_cls = (
        MultiTrackMusicalLinguisticSource if save_times else MusicalLinguisticSource
    )

    timelag_src = TimeLagFeatureSource(
        config.utt_list,
        config.timelag.label_phone_score_dir,
        config.timelag.label_phone_align_dir,
    )
    duration_src = DurationFeatureSource(config.utt_list, config.duration.label_dir)
    linguistic_phone_src = ling_cls(
        config.utt_list,
        config.timelag.label_phone_score_dir,
        config.question_path,
        add_frame_features=False,
    )
    acoustic_params = dict(config.acoustic.get("params", {}))
    # frame-level subphone feature mode (reference
    # bin/conf/prepare_features/acoustic/*.yaml subphone_features):
    # none / coarse_coding / minimal_phoneme for the phone-aligned singing
    # labels; the Merlin state modes additionally work on state-aligned
    # labels.  Canonical home is acoustic.params (what run_recipe packs
    # into the engine config); acoustic/top-level keys are accepted too.
    subphone_features = acoustic_params.get(
        "subphone_features",
        config.acoustic.get(
            "subphone_features",
            config.get("subphone_features", "coarse_coding"),
        ),
    )
    linguistic_frame_src = ling_cls(
        config.utt_list,
        config.acoustic.label_dir,
        config.question_path,
        add_frame_features=True,
        subphone_features=subphone_features,
    )
    acoustic_src = WORLDAcousticSource(
        config.utt_list,
        config.acoustic.wav_dir,
        config.acoustic.label_dir,
        config.question_path,
        **acoustic_params,
    )

    score_files, align_files = timelag_src.collect_files()
    dur_files = duration_src.collect_files()
    wav_files, ac_label_files = acoustic_src.collect_files()
    sources = (
        timelag_src,
        duration_src,
        linguistic_phone_src,
        linguistic_frame_src,
        acoustic_src,
    )

    jobs = [
        (
            i,
            (score_files[i], align_files[i]),
            dur_files[i],
            (wav_files[i], ac_label_files[i]),
            sources,
            out_dir,
            save_times,
        )
        for i in range(len(score_files))
    ]
    n_jobs = int(config.get("n_jobs", 1))
    if n_jobs > 1:
        with ProcessPoolExecutor(n_jobs) as pool:
            results = list(pool.map(_process_utt, jobs))
    else:
        results = [_process_utt(j) for j in jobs]
    ok = sum(1 for _, s in results if s)
    print(f"prepared features for {ok}/{len(results)} utterances -> {out_dir}")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    config = load_config(argv[0])
    if len(argv) > 1:
        config = merge(config, parse_overrides(argv[1:]))
    run(config)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
