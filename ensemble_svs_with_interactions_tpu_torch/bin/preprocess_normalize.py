"""Apply fitted scalers to feature dumps (parallel).

The recipe's stage 2, as ``ensemble_svs_with_interactions_tpu/bin/
preprocess_normalize.py``.

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.\
preprocess_normalize <in_dir> <scaler_prefix>
       <out_dir> [--type minmax|standard] [--n-jobs N]
"""

from __future__ import annotations

import argparse
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
    MinMaxScaler,
    StandardScaler,
)


def _load_scaler(prefix: str, kind: str):
    if kind == "minmax":
        return MinMaxScaler(
            np.load(f"{prefix}_min.npy"), np.load(f"{prefix}_scale.npy")
        )
    return StandardScaler(
        np.load(f"{prefix}_mean.npy"),
        np.load(f"{prefix}_var.npy"),
        np.load(f"{prefix}_scale.npy"),
    )


def _process(args):
    path, scaler, out_dir = args
    x = np.load(path)
    np.save(Path(out_dir) / path.name, scaler.transform(x).astype(np.float32))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("in_dir")
    ap.add_argument("scaler_prefix")
    ap.add_argument("out_dir")
    ap.add_argument("--type", choices=["minmax", "standard"], default="standard")
    ap.add_argument("--n-jobs", type=int, default=1)
    args = ap.parse_args(argv)

    scaler = _load_scaler(args.scaler_prefix, args.type)
    files = sorted(Path(args.in_dir).glob("*-feats.npy"))
    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    jobs = [(p, scaler, args.out_dir) for p in files]
    if args.n_jobs > 1:
        with ProcessPoolExecutor(args.n_jobs) as pool:
            list(pool.map(_process, jobs))
    else:
        for j in jobs:
            _process(j)
    # copy auxiliary files (-wave.npy, -times.npy) unchanged
    for suffix in ("-wave.npy", "-times.npy"):
        for p in sorted(Path(args.in_dir).glob(f"*{suffix}")):
            np.save(Path(args.out_dir) / p.name, np.load(p))
    print(f"normalized {len(files)} files -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
