"""Postfilters (counterparts in
``ensemble_svs_with_interactions_tpu/models/postfilters.py``): the host
GV postfilter.  The learned conv postfilters are not ported."""

from __future__ import annotations

import numpy as np


def variance_scaling(gv, feats, offset: int = 2, note_frame_indices=None):
    """Global-variance postfilter: rescale each dim's utterance variance
    (over ``note_frame_indices`` when given) to the training data's ``gv``;
    the first ``offset`` dims are left as they are.  Host NumPy."""
    feats = np.asarray(feats)
    gv = np.asarray(gv)
    if note_frame_indices is not None:
        if len(note_frame_indices) == 0:
            return feats
        sel = feats[note_frame_indices]
    else:
        sel = feats
    utt_gv = sel.var(0)
    utt_mu = sel.mean(0)
    out = feats.copy()
    scale = np.sqrt(gv[offset:] / np.maximum(utt_gv[offset:], 1e-12))
    if note_frame_indices is not None:
        out[note_frame_indices[:, None],
            np.arange(offset, feats.shape[1])[None, :]] = (
            scale * (feats[note_frame_indices][:, offset:] - utt_mu[offset:])
            + utt_mu[offset:])
    else:
        out[:, offset:] = (scale * (feats[:, offset:] - utt_mu[offset:])
                           + utt_mu[offset:])
    return out
