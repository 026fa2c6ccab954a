"""Fit feature scalers over training dumps.

The recipe's stage 2, as ``ensemble_svs_with_interactions_tpu/bin/
fit_scaler.py``: streaming partial_fit of MinMax (inputs) / Standard
(outputs) scalers, saved as .npy stats.

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.fit_scaler <feats_dir> <out_prefix>
       [--type minmax|standard] [--utt-list LIST]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
    MinMaxScaler,
    StandardScaler,
    save_scaler,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("feats_dir")
    ap.add_argument("out_prefix")
    ap.add_argument("--type", choices=["minmax", "standard"], default="standard")
    ap.add_argument("--utt-list", default=None)
    args = ap.parse_args(argv)

    files = sorted(Path(args.feats_dir).glob("*-feats.npy"))
    if args.utt_list:
        with open(args.utt_list) as f:
            keep = {line.strip() for line in f if line.strip()}
        files = [p for p in files if p.name.replace("-feats.npy", "") in keep]
    if not files:
        raise SystemExit(f"no feature files in {args.feats_dir}")

    scaler = MinMaxScaler() if args.type == "minmax" else StandardScaler()
    for p in files:
        scaler.partial_fit(np.load(p))
    save_scaler(scaler, args.out_prefix)
    print(f"fit {args.type} scaler over {len(files)} files -> {args.out_prefix}_*.npy")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
