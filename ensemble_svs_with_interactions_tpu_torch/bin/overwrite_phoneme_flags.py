"""Overwrite the ^FLAG_ phoneme-flag field of full-context labels.

Equivalent of the reference's utils/overwrite_phoneme_flags.py; the port's
copy of the JAX package's ``bin/overwrite_phoneme_flags.py``.

Usage: python -m ...bin.overwrite_phoneme_flags <in.lab|dir> <flag> <out_dir>
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ensemble_svs_with_interactions_tpu_torch.io import hts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("labels")
    ap.add_argument("flag")
    ap.add_argument("out_dir")
    args = ap.parse_args(argv)

    paths = (
        sorted(Path(args.labels).glob("*.lab"))
        if Path(args.labels).is_dir()
        else [Path(args.labels)]
    )
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for p in paths:
        labels = hts.load(p)
        hts.overwrite_phoneme_flags_(labels, args.flag)
        labels.save(out_dir / p.name)
    print(f"rewrote phoneme flags to '{args.flag}' for {len(paths)} files")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
