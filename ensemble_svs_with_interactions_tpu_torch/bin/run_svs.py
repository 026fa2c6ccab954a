"""Packed-model synthesis through the model registry; the port's copy of
``ensemble_svs_with_interactions_tpu/bin/run_svs.py``.  The models run on
``--device`` (``cuda`` unless ``--device cpu``).

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.run_svs
       <model_name_or_dir> <labels.lab> <out.wav> [--vocoder world]
       [--device cpu]
"""

from __future__ import annotations

import argparse

from scipy.io import wavfile

from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.pretrained import (
    create_svs_engine,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model")
    ap.add_argument("labels")
    ap.add_argument("out_wav")
    ap.add_argument("--vocoder", default="world")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engine = create_svs_engine(args.model, verbose=1, device=args.device)
    labels = hts.load(args.labels)
    wav, sr = engine.svs(labels, vocoder_type=args.vocoder)
    wavfile.write(args.out_wav, sr, wav)
    print(f"wrote {args.out_wav} ({len(wav) / sr:.2f}s, "
          f"RTF {engine.last_rtf:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
