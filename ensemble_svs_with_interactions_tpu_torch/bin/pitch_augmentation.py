"""Pitch augmentation: cent-shift extracted feature dumps.

Equivalent of the reference's utils/pitch_augmentation.py (the port's copy
of the JAX package's ``bin/pitch_augmentation.py``): shifts the
score-pitch columns of input linguistic dumps and the lf0 stream of output
acoustic dumps by a given number of cents, writing augmented copies with a
suffix.  Augmenting features (rather than audio) keeps WORLD analysis
untouched.

Usage: python -m ...bin.pitch_augmentation <dump_root> <shift_cents>
       --question-path qst.hed --acoustic-lf0-idx 60 [--suffix _aug]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.io import hts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dump_root", help="directory with in_*/out_* feature dirs")
    ap.add_argument("shift_cents", type=float)
    ap.add_argument("--question-path", required=True)
    ap.add_argument("--acoustic-lf0-idx", type=int, default=60)
    ap.add_argument("--suffix", default=None)
    args = ap.parse_args(argv)

    shift_lf0 = args.shift_cents * np.log(2) / 1200.0
    suffix = args.suffix or f"_aug{int(args.shift_cents):+d}"
    binary_dict, numeric_dict = hts.load_question_set(args.question_path)
    pitch_indices = hts.get_pitch_indices(binary_dict, numeric_dict)

    root = Path(args.dump_root)
    n = 0
    for phase_dir in sorted(root.glob("in_*")) + sorted(root.glob("out_*")):
        is_input = phase_dir.name.startswith("in_")
        is_acoustic_out = phase_dir.name == "out_acoustic"
        for path in sorted(phase_dir.glob("*-feats.npy")):
            if suffix in path.stem:
                continue
            x = np.load(path)
            if is_input:
                # interpolated log-F0 conditioning columns
                for idx in pitch_indices:
                    if idx < x.shape[1]:
                        x[:, idx] += shift_lf0
            elif is_acoustic_out and args.acoustic_lf0_idx < x.shape[1]:
                x[:, args.acoustic_lf0_idx] += shift_lf0
            out = path.with_name(
                path.name.replace("-feats.npy", f"{suffix}-feats.npy")
            )
            np.save(out, x)
            n += 1
    print(f"wrote {n} augmented dumps (shift {args.shift_cents} cents)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
