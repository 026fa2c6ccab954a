"""Multitrack feature extraction CLI (surface parity with the reference's
prepare_features_multitrack.py).

Same extraction path as ``bin.prepare_features``; the multitrack pairing
itself happens at dataset-build time (``data.multitrack``), so this tool
differs from the single-track one only in intent.  It does NOT dump
note-onset ``-times.npy`` arrays — use
``bin.prepare_features_multitrack_sync`` when training with the
note-synchronized collate (sync="notes"), exactly as in the reference
(prepare_features_multitrack.py vs prepare_features_multitrack_sync.py:91-309,
where only the _sync variant saves ``-times.npy``).
"""

from __future__ import annotations

import sys

from ensemble_svs_with_interactions_tpu_torch.bin.prepare_features import run
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    load_config,
    merge,
    parse_overrides,
)


def main(argv=None, force_note_times=False):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    config = load_config(argv[0])
    if len(argv) > 1:
        config = merge(config, parse_overrides(argv[1:]))
    if force_note_times:
        config = merge(config, {"save_note_times": True})
    run(config)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
