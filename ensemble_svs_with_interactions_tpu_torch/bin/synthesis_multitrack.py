"""Multitrack synthesis CLI: synthesize every ordered same-segment singer
pair with cross-track conditioning; the port's copy of
``ensemble_svs_with_interactions_tpu/bin/synthesis_multitrack.py``.

For every pair of label files sharing a segment id, run multitrack timing
+ acoustic inference on (main, sub), synthesize the main track, and dump
wav + mgc/logF0/vuv/bap/timelag/duration arrays.  The models and WORLD run
on ``--device`` (``cuda`` unless ``--device cpu``).

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.synthesis_multitrack
       <model_dir> <label_dir> <out_dir> --spk-names alto,soprano
       [--device cpu] [...]

Label files must be named ``spk_segment.lab``.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np
import torch
from scipy.io import wavfile

from ensemble_svs_with_interactions_tpu_torch import gen_multitrack
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

_SPK_RE = re.compile(r"^([A-Za-z0-9]+)_(.+)$")


def group_by_segment(paths, spk_names):
    """{segment: [(singer, path), ...]} of ``spk_segment.lab`` files: the
    singer prefix matched against the declared names first, longest first
    (names may contain underscores), else a generic ``<spk>_<segment>``
    split; files that match neither are left out."""
    by_segment = {}
    for path in paths:
        spk = next(
            (
                s
                for s in sorted(spk_names, key=len, reverse=True)
                if path.stem.startswith(s + "_")
            ),
            None,
        )
        if spk is not None:
            by_segment.setdefault(path.stem[len(spk) + 1 :], []).append(
                (spk, path)
            )
            continue
        m = _SPK_RE.match(path.stem)
        if not m:
            continue
        by_segment.setdefault(m.group(2), []).append((m.group(1), path))
    return by_segment


def ordered_pairs(by_segment):
    """(segment, (main singer, path), (sub singer, path)) of every ordered
    pair of a segment's tracks, a lone track paired with itself."""
    for seg, entries in sorted(by_segment.items()):
        for i, main in enumerate(entries):
            for j, sub in enumerate(entries):
                if i == j and len(entries) > 1:
                    continue
                yield seg, main, sub


class MultiTrackSPSVS(SPSVS):
    """SPSVS over multitrack packed models (timing + acoustic conditioned
    on a sub track), with the JAX CLI's calls: the timing models with the
    default clip ranges, on the caller's labels (rounded in place)."""

    last_duration_modified = None

    def predict_timing_multitrack(self, labels_list, spks_list):
        return gen_multitrack.predict_timing_multitrack(
            labels_list,
            spks_list,
            self.binary_dict,
            self.numeric_dict,
            self.timelag_model,
            self.in_timelag_scaler,
            self.out_timelag_scaler,
            self.duration_model,
            self.in_duration_scaler,
            self.out_duration_scaler,
            force_clip_input_features=self._force_clip("timelag"),
            force_clip_input_features_duration=self._force_clip("duration"),
            frame_period=self.frame_period,
        )[0]

    def predict_acoustic_multitrack(self, labels_list, spks_list):
        return gen_multitrack.predict_acoustic_multitrack(
            labels_list,
            spks_list,
            self.acoustic_model,
            self.in_acoustic_scaler,
            self.out_acoustic_scaler,
            self.binary_dict,
            self.numeric_dict,
            force_clip_input_features=self._force_clip("acoustic"),
            frame_period=self.frame_period,
        )

    @torch.no_grad()
    def svs_multitrack(self, labels_main, labels_sub, spk_main, spk_sub, **kw):
        duration_modified = self.predict_timing_multitrack(
            [labels_main, labels_sub], [spk_main, spk_sub]
        )
        duration_modified_sub = self.predict_timing_multitrack(
            [labels_sub, labels_main], [spk_sub, spk_main]
        )
        acoustic = self.predict_acoustic_multitrack(
            [duration_modified, duration_modified_sub], [spk_main, spk_sub]
        )
        streams = self.postprocess_acoustic(acoustic, duration_modified, **kw)
        wav = self.predict_waveform(streams, vocoder_type="world")
        wav = self.postprocess_waveform(wav)
        self.last_duration_modified = duration_modified
        return wav, self.sample_rate, streams, duration_modified


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model_dir")
    ap.add_argument("label_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--spk-names", required=True, help="comma-separated")
    ap.add_argument("--verbose", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spk_names = args.spk_names.split(",")
    engine = MultiTrackSPSVS(args.model_dir, verbose=args.verbose,
                             device=args.device)
    out_dir = Path(args.out_dir)
    for sub in ("wav", "mgc", "logF0", "vuv", "bap", "timelag", "duration"):
        (out_dir / sub).mkdir(parents=True, exist_ok=True)

    by_segment = group_by_segment(sorted(Path(args.label_dir).glob("*.lab")),
                                  spk_names)
    n = 0
    for seg, (spk_m, path_m), (spk_s, path_s) in ordered_pairs(by_segment):
        labels_m = hts.load(path_m)
        labels_s = hts.load(path_s)
        spk_id_m = spk_names.index(spk_m) if spk_m in spk_names else 0
        spk_id_s = spk_names.index(spk_s) if spk_s in spk_names else 0
        wav, sr, streams, _ = engine.svs_multitrack(
            labels_m, labels_s, spk_id_m, spk_id_s
        )
        name = f"{spk_m}_{seg}_with_{spk_s}"
        wavfile.write(out_dir / "wav" / f"{name}.wav", sr, wav)
        mgc, lf0, vuv, bap = streams
        np.save(out_dir / "mgc" / f"{name}.npy", mgc)
        np.save(out_dir / "logF0" / f"{name}.npy", lf0)
        np.save(out_dir / "vuv" / f"{name}.npy", vuv)
        np.save(out_dir / "bap" / f"{name}.npy", bap)
        # timing dumps for offline evaluation
        mod = engine.last_duration_modified or labels_m
        shift = int(engine.frame_period * 1e4)
        notes = hts.get_note_indices(labels_m)
        lag = (
            np.asarray(mod.start_times)[notes]
            - np.asarray(labels_m.start_times)[notes]
        ) / shift
        durs = (
            np.asarray(mod.end_times) - np.asarray(mod.start_times)
        ) / shift
        np.save(out_dir / "timelag" / f"{name}.npy", lag)
        np.save(out_dir / "duration" / f"{name}.npy", durs)
        n += 1
        print(f"[{n}] {name}: {len(wav)/sr:.2f}s")
    print(f"synthesized {n} main/sub pairs -> {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
