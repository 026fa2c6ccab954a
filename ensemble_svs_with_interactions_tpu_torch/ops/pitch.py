"""F0 helpers used by the featurizer (``interp1d`` of
``ensemble_svs_with_interactions_tpu/ops/pitch.py``)."""

from __future__ import annotations

import numpy as np


def interp1d(f0: np.ndarray, kind: str = "slinear") -> np.ndarray:
    """Piecewise-linear interpolation of positive F0 over gaps; edges hold
    the nearest positive value.  Accepts (T,) or (T, 1)."""
    if kind not in ("slinear", "linear"):
        raise NotImplementedError(f"interp1d kind={kind!r} is not supported")
    f0 = np.asarray(f0)
    squeeze = f0.ndim == 2
    flat = f0.reshape(-1).astype(np.float64)
    nz = np.nonzero(flat > 0)[0]
    out = flat if len(nz) == 0 else np.interp(np.arange(len(flat)), nz,
                                              flat[nz])
    out = out.astype(f0.dtype if f0.dtype.kind == "f" else np.float64)
    return out.reshape(f0.shape) if squeeze else out
