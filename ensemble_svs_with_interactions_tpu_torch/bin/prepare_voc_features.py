"""Vocoder-training inputs from acoustic feature dumps: the static
streams of each ``*-feats.npy`` (float32) and a copy of its aligned
``*-wave.npy``, as the JAX package's ``bin/prepare_voc_features.py``
writes them.

``python -m ensemble_svs_with_interactions_tpu_torch.bin.prepare_voc_features
<acoustic_dump_dir> <out_dir> --stream-sizes 180,3,1,15 --num-windows 3
[--has-dynamic-features 1,1,0,1]``
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    get_static_features,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("acoustic_dump_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--stream-sizes", default="180,3,1,15")
    ap.add_argument("--num-windows", type=int, default=3)
    ap.add_argument("--has-dynamic-features", default="1,1,0,1")
    args = ap.parse_args(argv)

    stream_sizes = [int(s) for s in args.stream_sizes.split(",")]
    has_dyn = [bool(int(s)) for s in args.has_dynamic_features.split(",")]
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for path in sorted(Path(args.acoustic_dump_dir).glob("*-feats.npy")):
        feats = np.load(path)
        if any(has_dyn):
            parts = get_static_features(feats[None], args.num_windows,
                                        stream_sizes, has_dyn)
            feats = np.concatenate([np.asarray(p)[0] for p in parts],
                                   axis=-1)
        np.save(out_dir / path.name, feats.astype(np.float32))
        wave = Path(str(path).replace("-feats.npy", "-wave.npy"))
        if wave.exists():
            shutil.copyfile(wave, out_dir / wave.name)
        n += 1
    print(f"prepared vocoder features for {n} utterances -> {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
