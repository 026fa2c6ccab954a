"""Multitrack timing evaluation CLI: ``bin.evaluate_timing`` with the
multitrack pairing forced on; the port's copy of
``ensemble_svs_with_interactions_tpu/bin/evaluate_timing_multitrack.py``.

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.evaluate_timing_multitrack
       <model_dir> <score_label_dir> <align_label_dir> <out_dir>
       [--spk-names a,b] [--device cpu]
"""

from __future__ import annotations

import sys

from ensemble_svs_with_interactions_tpu_torch.bin.evaluate_timing import (
    main as _main,
)


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    if "--multitrack" not in argv:
        argv.append("--multitrack")
    return _main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
