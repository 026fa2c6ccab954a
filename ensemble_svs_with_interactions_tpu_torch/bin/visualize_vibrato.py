"""Visualize vibrato analysis on a wav file.

Equivalent of the reference's utils/visualize_vibrato.py (the port's copy of
the JAX package's ``bin/visualize_vibrato.py``; ``matplotlib`` imported
only when it runs, with the Agg backend): plots the
smoothed F0 (cents), vibrato likelihood, detected sections and extracted
rate/extent parameters.

Usage: python -m ...bin.visualize_vibrato <wav> <out.png>
       [--f0-floor N --f0-ceil N]
"""

from __future__ import annotations

import argparse

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.data.data_source import load_wav
from ensemble_svs_with_interactions_tpu_torch.ops.world import analysis
from ensemble_svs_with_interactions_tpu_torch.ops.pitch import (
    extract_smoothed_f0,
    extract_vibrato_likelihood,
    extract_vibrato_parameters,
    hz_to_cent_based_c4,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("wav")
    ap.add_argument("out_png")
    ap.add_argument("--f0-floor", type=float, default=120)
    ap.add_argument("--f0-ceil", type=float, default=700)
    ap.add_argument("--frame-period", type=float, default=5.0)
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x, fs = load_wav(args.wav)
    f0, t = analysis.dio(
        x, fs, args.frame_period, f0_floor=args.f0_floor, f0_ceil=args.f0_ceil
    )
    f0 = analysis.stonemask(x, f0, t, fs)
    sr_f0 = int(1000 / args.frame_period)
    f0_smooth = extract_smoothed_f0(f0, sr_f0, cutoff=8)
    cents = hz_to_cent_based_c4(f0_smooth)
    like = extract_vibrato_likelihood(cents, sr_f0, win_length=64, n_fft=256)
    flags, m_a, m_f = extract_vibrato_parameters(cents, like, sr_f0)

    fig, axes = plt.subplots(4, 1, figsize=(12, 9), sharex=True)
    axes[0].plot(t, np.where(cents > 0, cents, np.nan))
    axes[0].set_ylabel("F0 [cent]")
    axes[1].plot(t, like)
    axes[1].set_ylabel("vibrato likelihood")
    axes[2].fill_between(t, flags, alpha=0.5)
    axes[2].set_ylabel("vibrato flag")
    axes[3].plot(t, m_a, label="extent m_a [cent]")
    axes[3].plot(t, m_f * 10, label="rate m_f x10 [Hz]")
    axes[3].legend()
    axes[3].set_xlabel("time [s]")
    fig.tight_layout()
    fig.savefig(args.out_png, dpi=90)
    print(
        f"vibrato frames: {flags.sum()} / {len(flags)} "
        f"({100*flags.mean():.1f}%) -> {args.out_png}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
