"""Maximum-likelihood parameter generation on the host: the NumPy/SciPy
path of ``ensemble_svs_with_interactions_tpu/ops/mlpg.py`` (banded normal
equations solved with LAPACK's SPD banded solver).  The JAX package's
device banded-Cholesky kernel is not on the serving path and is not
ported."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Window = Tuple[int, int, np.ndarray]

_VAR_FLOOR = 1e-12


def window_coeffs(windows: Sequence[Window]) -> List[np.ndarray]:
    """Normalize window specs to symmetric odd-length coefficient arrays."""
    out = []
    for left, right, coefs in windows:
        coefs = np.asarray(coefs, dtype=np.float64)
        width = max(left, right)
        full = np.zeros(2 * width + 1)
        full[width - left: width + right + 1] = coefs
        out.append(full)
    return out


def default_windows(num_windows: int = 3) -> List[Window]:
    """Standard static/delta/delta-delta windows."""
    windows: List[Window] = [(0, 0, np.array([1.0]))]
    if num_windows >= 2:
        windows.append((1, 1, np.array([-0.5, 0.0, 0.5])))
    if num_windows >= 3:
        windows.append((1, 1, np.array([1.0, -2.0, 1.0])))
    if num_windows >= 4:
        raise ValueError(f"unsupported number of windows: {num_windows}")
    return windows


def _build_banded_system_np(means, precisions, windows: Sequence[Window]):
    """Compact banded normal equations: band (k+1, T, D) with
    band[delta, t] = A[t, t+delta], and rhs (T, D)."""
    coeff_list = window_coeffs(windows)
    W = len(coeff_list)
    T = means.shape[0]
    D = means.shape[1] // W
    k = 2 * max((len(c) - 1) // 2 for c in coeff_list)
    band = np.zeros((k + 1, T, D), dtype=np.float64)
    rhs = np.zeros((T, D), dtype=np.float64)

    def shifted(x, j):
        if j == 0:
            return x
        out = np.zeros_like(x)
        if j > 0:
            out[j:] = x[:-j]
        else:
            out[:j] = x[-j:]
        return out

    for w, coefs in enumerate(coeff_list):
        half = (len(coefs) - 1) // 2
        p_w = precisions[:, w * D: (w + 1) * D]
        pu_w = p_w * means[:, w * D: (w + 1) * D]
        for j in range(-half, half + 1):
            c_j = float(coefs[j + half])
            if c_j == 0.0:
                continue
            rhs += c_j * shifted(pu_w, j)
            for delta in range(0, k + 1):
                jd = j + delta
                if jd < -half or jd > half:
                    continue
                c_jd = float(coefs[jd + half])
                if c_jd == 0.0:
                    continue
                band[delta] += c_j * c_jd * shifted(p_w, j)
    return band, rhs


def _mlpg_host(means, variances, num_windows: int) -> np.ndarray:
    """MLPG via scipy's ``solveh_banded``, one feature dim at a time."""
    from scipy.linalg import solveh_banded

    windows = default_windows(num_windows)
    precisions = 1.0 / np.maximum(np.asarray(variances, np.float64),
                                  _VAR_FLOOR)
    band, rhs = _build_banded_system_np(np.asarray(means, np.float64),
                                        precisions, windows)
    k = band.shape[0] - 1
    T, D = rhs.shape
    y = np.empty((T, D))
    ab = np.zeros((k + 1, T))
    for d in range(D):
        for delta in range(k + 1):
            ab[k - delta, delta:] = band[delta, : T - delta, d]
            if delta:
                ab[k - delta, :delta] = 0.0
        y[:, d] = solveh_banded(ab, rhs[:, d], lower=False)
    return y


def mlpg(means: np.ndarray, variances, windows=3) -> np.ndarray:
    """MLPG for one (T, W*D) sequence of window means; ``variances`` is
    (T, W*D) or (W*D,).  Returns the (T, D) static trajectory."""
    if isinstance(windows, int):
        num_windows = windows
    else:
        num_windows = len(windows)
        for (l1, r1, c1), (l2, r2, c2) in zip(windows,
                                              default_windows(num_windows)):
            if (l1, r1) != (l2, r2) or not np.allclose(c1, c2):
                raise NotImplementedError(
                    "mlpg only supports the standard delta windows "
                    f"(default_windows({num_windows})); got {windows}")
    if num_windows == 1:
        return means
    v = np.asarray(variances)
    if v.ndim == 1:
        v = np.broadcast_to(v[None, :], means.shape)
    return _mlpg_host(means, v, num_windows)
