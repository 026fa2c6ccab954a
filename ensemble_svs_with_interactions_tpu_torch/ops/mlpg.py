"""Maximum-likelihood parameter generation (MLPG), as in
``ensemble_svs_with_interactions_tpu/ops/mlpg.py``: the smooth static
trajectory y of the banded SPD normal equations

    (W^T Sigma^-1 W) y = W^T Sigma^-1 u

for per-frame window means u and variances.  Two paths: NumPy arrays are
solved on the host with LAPACK's SPD banded solver (``_mlpg_host``, every
serving caller's path), torch tensors on their own device in their own
dtype (``_mlpg_device``: the compact band built by shifted elementwise
products, then a banded Cholesky factorisation with forward substitution
and a backward substitution, each a loop over time of small torch ops
vectorised across the feature columns, as JAX's two ``lax.scan`` loops).
``apply_delta_windows`` gives the dynamic features of feature
extraction."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

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


def build_banded_system(means: torch.Tensor, precisions: torch.Tensor,
                        windows: Sequence[Window]):
    """Compact banded normal equations on the tensors' device: band (k+1,
    T, D) with band[delta, t] = A[t, t+delta], and rhs (T, D), in the
    means' dtype."""
    coeff_list = window_coeffs(windows)
    W = len(coeff_list)
    T = means.shape[0]
    D = means.shape[1] // W
    k = 2 * max((len(c) - 1) // 2 for c in coeff_list)
    band = [means.new_zeros((T, D)) for _ in range(k + 1)]
    rhs = means.new_zeros((T, D))

    def shifted(x, j):
        """x[t - j] with zeros outside [0, T)."""
        if j == 0:
            return x
        if j > 0:
            return torch.cat([x.new_zeros((j,) + x.shape[1:]), x[:-j]])
        return torch.cat([x[-j:], x.new_zeros((-j,) + x.shape[1:])])

    for w, coefs in enumerate(coeff_list):
        half = (len(coefs) - 1) // 2
        p_w = precisions[:, w * D: (w + 1) * D]
        pu_w = p_w * means[:, w * D: (w + 1) * D]
        for j in range(-half, half + 1):
            c_j = float(coefs[j + half])
            if c_j == 0.0:
                continue
            rhs = rhs + c_j * shifted(pu_w, j)
            for delta in range(0, k + 1):
                jd = j + delta
                if jd < -half or jd > half:
                    continue
                c_jd = float(coefs[jd + half])
                if c_jd == 0.0:
                    continue
                band[delta] = band[delta] + c_j * c_jd * shifted(p_w, j)
    return torch.stack(band, dim=0), rhs


def banded_cholesky_solve(band: torch.Tensor, rhs: torch.Tensor):
    """Solve A y = rhs for a symmetric positive-definite banded A given as
    band (k+1, T, D), band[delta, t] = A[t, t+delta], per feature column;
    rhs (T, D).  Returns y (T, D).

    Two loops over time, each step O(k^2) elementwise ops over D: the
    factorisation with the forward substitution, then the backward
    substitution.  The carries are Python lists of (D,) tensors, so moving
    them along costs no op."""
    kp1, T, D = band.shape
    k = kp1 - 1
    zero = rhs.new_zeros((D,))
    # cols[m - 1][delta] = L[t - m + delta, t - m]; zs[m - 1] = z[t - m]
    cols = [[zero] * (k + 1) for _ in range(k)]
    zs = [zero] * k
    l_cols, z = [], []
    for t in range(T):
        a_t, b_t = band[:, t], rhs[t]
        lt_prev = [cols[m - 1][m] for m in range(1, k + 1)]  # L[t, t-m]
        sq = lt_prev[0] * lt_prev[0]
        for m in range(1, k):
            sq = sq + lt_prev[m] * lt_prev[m]
        diag = torch.clamp_min(a_t[0] - sq, _VAR_FLOOR)
        l_tt = torch.sqrt(diag)
        new_col = [l_tt]
        for delta in range(1, k + 1):
            # L[t+delta, t-m] = cols[m-1][m+delta] (0 beyond the band)
            acc = a_t[delta]
            for m in range(1, k + 1):
                if m + delta <= k:
                    acc = acc - cols[m - 1][m + delta] * lt_prev[m - 1]
            new_col.append(acc / l_tt)
        dot = lt_prev[0] * zs[0]
        for m in range(1, k):
            dot = dot + lt_prev[m] * zs[m]
        z_t = (b_t - dot) / l_tt
        cols = [new_col] + cols[:-1]
        zs = [z_t] + zs[:-1]
        l_cols.append(new_col)
        z.append(z_t)
    # y[t] = (z[t] - sum_m L[t+m, t] y[t+m]) / L[t, t]
    ys = [zero] * k
    y = [None] * T
    for t in range(T - 1, -1, -1):
        col_t = l_cols[t]
        dot = col_t[1] * ys[0]
        for m in range(1, k):
            dot = dot + col_t[m + 1] * ys[m]
        y_t = (z[t] - dot) / col_t[0]
        ys = [y_t] + ys[:-1]
        y[t] = y_t
    return torch.stack(y, dim=0)


def _mlpg_device(means: torch.Tensor, variances: torch.Tensor,
                 num_windows: int) -> torch.Tensor:
    """MLPG of one (T, W*D) sequence on the tensors' device."""
    windows = default_windows(num_windows)
    precisions = 1.0 / torch.clamp_min(variances, _VAR_FLOOR)
    band, rhs = build_banded_system(means, precisions, windows)
    return banded_cholesky_solve(band, rhs)


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


def mlpg(means, variances, windows=3):
    """MLPG for one (T, W*D) sequence of window means; ``variances`` is
    (T, W*D) or (W*D,).  Returns the (T, D) static trajectory: a NumPy
    array solved on the host for NumPy means, a tensor on the means'
    device and in their dtype for a torch tensor."""
    if isinstance(windows, int):
        num_windows = windows
    else:
        num_windows = len(windows)
        # the banded solvers are specialised to the standard delta /
        # delta-delta windows; refuse silently different coefficients
        for (l1, r1, c1), (l2, r2, c2) in zip(windows,
                                              default_windows(num_windows)):
            if (l1, r1) != (l2, r2) or not np.allclose(c1, c2):
                raise NotImplementedError(
                    "mlpg only supports the standard delta windows "
                    f"(default_windows({num_windows})); got {windows}")
    if num_windows == 1:
        return means
    if isinstance(means, torch.Tensor):
        v = torch.as_tensor(variances, dtype=means.dtype, device=means.device)
        if v.ndim == 1:
            v = v[None, :].expand(means.shape)
        return _mlpg_device(means, v, num_windows)
    v = np.asarray(variances)
    if v.ndim == 1:
        v = np.broadcast_to(v[None, :], means.shape)
    return _mlpg_host(means, v, num_windows)


def apply_delta_windows(x: np.ndarray, windows: Sequence[Window]) -> np.ndarray:
    """Static and dynamic features: each window applied along time, edge
    frames replicating the boundary value (nnmnkwii's convention)."""
    x = np.asarray(x)
    T, D = x.shape
    outs = []
    for left, right, coefs in windows:
        coefs = np.asarray(coefs, dtype=x.dtype)
        width = max(left, right)
        if width == 0:
            outs.append(x * float(coefs[0]))
            continue
        padded = np.pad(x, ((width, width), (0, 0)), mode="edge")
        full = np.zeros(2 * width + 1, dtype=x.dtype)
        full[width - left: width + right + 1] = coefs
        acc = np.zeros_like(x)
        for j, c in enumerate(full):
            if c == 0.0:
                continue
            acc += c * padded[j: j + T]
        outs.append(acc)
    return np.concatenate(outs, axis=1)
