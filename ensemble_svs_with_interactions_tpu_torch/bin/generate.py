"""Offline feature generation: run a packed voice's acoustic model over
feature dumps; the port's copy of
``ensemble_svs_with_interactions_tpu/bin/generate.py``.

Runs the acoustic model on normalized input dumps (``*-feats.npy``) and
writes denormalized static features (postfilter / vocoder training
targets): ``gen._denorm_and_mlpg`` on the host, after the model on
``--device`` (``cuda`` unless ``--device cpu``).

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.generate
       <model_dir> <in_feats_dir> <out_dir> [--static-only] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch import gen
from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    get_static_features,
)
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model_dir")
    ap.add_argument("in_feats_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--static-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engine = SPSVS(args.model_dir, device=args.device)
    model = engine.acoustic_model
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for path in sorted(Path(args.in_feats_dir).glob("*-feats.npy")):
        x = np.load(path).astype(np.float32)
        pred = model.inference(x)
        is_prob = model.prediction_type().name in (
            "PROBABILISTIC", "MULTISTREAM_HYBRID",
        )
        feats = gen._denorm_and_mlpg(
            pred, engine.out_acoustic_scaler, model.config, is_prob
        )
        if args.static_only and np.any(model.config.has_dynamic_features):
            parts = get_static_features(
                feats[None],
                int(model.config.num_windows),
                list(model.config.stream_sizes),
                list(model.config.has_dynamic_features),
            )
            feats = np.concatenate([np.asarray(p)[0] for p in parts], axis=-1)
        np.save(out_dir / path.name, feats.astype(np.float32))
        n += 1
    print(f"generated features for {n} utterances -> {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
