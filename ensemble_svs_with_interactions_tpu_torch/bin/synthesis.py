"""Single-track synthesis CLI: packed model + labels -> wav; the port's
copy of ``ensemble_svs_with_interactions_tpu/bin/synthesis.py``.  The
models and the vocoder run on ``--device`` (``cuda`` unless ``--device
cpu``).

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.synthesis
       <model_dir> <label_file_or_dir> <out_dir> [--vocoder world]
       [--post-filter gv] [--segmented] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from scipy.io import wavfile

from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model_dir")
    ap.add_argument("labels")
    ap.add_argument("out_dir")
    ap.add_argument("--vocoder", default="world")
    ap.add_argument("--post-filter", default="gv")
    ap.add_argument("--segmented", action="store_true")
    ap.add_argument("--verbose", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engine = SPSVS(args.model_dir, verbose=args.verbose, device=args.device)
    label_paths = (
        sorted(Path(args.labels).glob("*.lab"))
        if Path(args.labels).is_dir()
        else [Path(args.labels)]
    )
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for path in label_paths:
        labels = hts.load(path)
        wav, sr = engine.svs(
            labels,
            vocoder_type=args.vocoder,
            post_filter_type=args.post_filter,
            segmented_synthesis=args.segmented,
        )
        out = out_dir / f"{path.stem}.wav"
        wavfile.write(out, sr, wav)
        print(f"wrote {out} ({len(wav)/sr:.2f}s, RTF {engine.last_rtf:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
