"""Note-synchronized multitrack feature extraction CLI (surface parity
with the reference's prepare_features_multitrack_sync.py:91-309).

Identical to ``bin.prepare_features_multitrack`` plus per-utterance
``-times.npy`` note-onset dumps next to every feature file — the arrays
the cross-track two-pointer note merge (``data.multitrack`` sync="notes")
aligns on.  In the reference the _sync app re-extracts features with a
``MultiTrackMusicalLinguisticSource`` that also returns absolute note
times; here the shared extraction path already computes them, so this
tool just switches the dump on.
"""

from __future__ import annotations

import sys

from ensemble_svs_with_interactions_tpu_torch.bin.prepare_features_multitrack import (
    main as _main,
)


def main(argv=None):
    return _main(argv, force_note_times=True)


if __name__ == "__main__":
    raise SystemExit(main())
