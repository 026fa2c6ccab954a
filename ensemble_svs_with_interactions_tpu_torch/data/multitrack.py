"""Note-level merge of two tracks (``merge_tracks_by_notes`` of
``ensemble_svs_with_interactions_tpu/data/multitrack.py``)."""

from __future__ import annotations

import numpy as np


def merge_tracks_by_notes(x0, y0, times0, x1, y1, times1):
    """Two-pointer merge of two note/phone sequences into one timeline.

    Where a track has no event at a merged position, zero rows are inserted
    and its presence mask is False.  Returns (mx0, my0, mask0, mx1, my1,
    mask1), all of the merged length.
    """
    a = np.append(times0, times0[-1] + times1[-1])
    b = np.append(times1, times0[-1] + times1[-1])
    rows0, rows1, ry0, ry1, m0, m1 = [], [], [], [], [], []
    aid = bid = 0
    while aid < len(a) - 1 or bid < len(b) - 1:
        if a[aid] < b[bid]:
            rows0.append(x0[aid])
            rows1.append(np.zeros_like(x0[aid]))
            ry0.append(y0[aid])
            ry1.append(np.zeros_like(y0[aid]))
            m0.append(True)
            m1.append(False)
            aid += 1
        elif a[aid] > b[bid]:
            rows0.append(np.zeros_like(x1[bid]))
            rows1.append(x1[bid])
            ry0.append(np.zeros_like(y1[bid]))
            ry1.append(y1[bid])
            m0.append(False)
            m1.append(True)
            bid += 1
        else:
            rows0.append(x0[aid])
            rows1.append(x1[bid])
            ry0.append(y0[aid])
            ry1.append(y1[bid])
            m0.append(True)
            m1.append(True)
            aid += 1
            bid += 1
    return (np.asarray(rows0, np.float32), np.asarray(ry0, np.float32),
            np.asarray(m0, bool), np.asarray(rows1, np.float32),
            np.asarray(ry1, np.float32), np.asarray(m1, bool))
