"""The port's device MLPG (``ops/mlpg.py`` on a torch tensor) against the
JAX package's jitted banded-Cholesky scan (``_mlpg_jit``) on the CPU, in
float32: 1, 2 and 3 windows, odd and tiny T, per-frame (T, W*D) and
global (W*D,) variances, at ATOL.  Both paths lie within DENSE_ATOL (the
JAX package's own tolerance against a dense solve, its
``tests/test_ops.py``) of the dense float64 solve of the normal equations.
Non-standard windows raise as in JAX, and one window is the identity.
"""

import jax
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.ops import mlpg as jax_mlpg
from ensemble_svs_with_interactions_tpu_torch.ops import mlpg
from tests.test_torch_svs import few_threads  # noqa: F401

ATOL = 1e-4
DENSE_ATOL = 2e-3
D = 5


def dense_solve(means, variances, num_windows):
    """y of (W^T P W) y = W^T P u, built as dense float64 matrices."""
    T = means.shape[0]
    windows = mlpg.default_windows(num_windows)
    rows, prec, u = [], [], []
    for w, (left, right, coefs) in enumerate(windows):
        full = mlpg.window_coeffs([(left, right, coefs)])[0]
        half = (len(full) - 1) // 2
        Wm = np.zeros((T, T))
        for t in range(T):
            for j, c in enumerate(full):
                s = t + j - half
                if 0 <= s < T:
                    Wm[t, s] = c
        rows.append(Wm)
    y = np.zeros((T, D))
    for d in range(D):
        A = np.zeros((T, T))
        b = np.zeros(T)
        for w, Wm in enumerate(rows):
            p = 1.0 / np.maximum(variances[:, w * D + d].astype(np.float64),
                                 1e-12)
            A += Wm.T @ (p[:, None] * Wm)
            b += Wm.T @ (p * means[:, w * D + d])
        y[:, d] = np.linalg.solve(A, b)
    return y


def inputs(T, W, seed, per_frame):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((T, W * D)).astype(np.float32)
    var = rng.uniform(0.05, 2.0, (T, W * D)).astype(np.float32)
    return means, (var if per_frame else var[0])


@pytest.mark.parametrize("per_frame", [True, False], ids=["TWD", "WD"])
@pytest.mark.parametrize("T", [1, 2, 9, 33])
@pytest.mark.parametrize("W", [2, 3])
def test_device_mlpg_matches_jax_scan(W, T, per_frame):
    means, var = inputs(T, W, seed=10 * W + T, per_frame=per_frame)
    got = mlpg.mlpg(torch.from_numpy(means), torch.from_numpy(var), W)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == (T, D)
    full_var = np.broadcast_to(var, means.shape)
    ref = np.asarray(jax_mlpg._mlpg_jit(means, full_var, W))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    dense = dense_solve(means, np.asarray(full_var), W)
    np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=DENSE_ATOL)
    np.testing.assert_allclose(ref, dense, rtol=0, atol=DENSE_ATOL)
    host = mlpg.mlpg(means.astype(np.float64), var.astype(np.float64), W)
    assert isinstance(host, np.ndarray)
    np.testing.assert_allclose(host, dense, rtol=0, atol=1e-9)


def test_device_mlpg_keeps_the_tensors_dtype():
    """float64 in, float64 out: the factorisation runs in the tensor's
    dtype and then agrees with the host path to float64 rounding."""
    means, var = inputs(17, 3, seed=4, per_frame=True)
    got = mlpg.mlpg(torch.from_numpy(means).double(),
                    torch.from_numpy(var).double(), 3)
    assert got.dtype == torch.float64
    host = mlpg.mlpg(means.astype(np.float64), var.astype(np.float64), 3)
    np.testing.assert_allclose(got.numpy(), host, rtol=0, atol=1e-10)


def test_device_mlpg_takes_window_specs_and_numpy_variances():
    means, var = inputs(12, 3, seed=5, per_frame=False)
    got = mlpg.mlpg(torch.from_numpy(means), var, mlpg.default_windows(3))
    ref = np.asarray(jax_mlpg.mlpg(jax.numpy.asarray(means),
                                   jax.numpy.asarray(var),
                                   jax_mlpg.default_windows(3)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


def test_one_window_is_the_identity():
    means, var = inputs(7, 1, seed=6, per_frame=True)
    x = torch.from_numpy(means)
    assert mlpg.mlpg(x, torch.from_numpy(var), 1) is x
    np.testing.assert_array_equal(
        np.asarray(jax_mlpg.mlpg(jax.numpy.asarray(means), var, 1)), means)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_non_standard_windows_raise(pkg):
    mod = mlpg if pkg == "port" else jax_mlpg
    means, var = inputs(6, 2, seed=7, per_frame=True)
    bad = [(0, 0, np.array([1.0])), (1, 1, np.array([-1.0, 0.0, 1.0]))]
    x = torch.from_numpy(means) if pkg == "port" else jax.numpy.asarray(means)
    with pytest.raises(NotImplementedError, match="standard delta windows"):
        mod.mlpg(x, var, bad)
    with pytest.raises(ValueError, match="unsupported number of windows"):
        mod.default_windows(4)


def test_banded_system_is_jax_s():
    """The compact band and right-hand side against JAX's at float32."""
    means, var = inputs(11, 3, seed=8, per_frame=True)
    prec = (1.0 / var).astype(np.float32)
    band, rhs = mlpg.build_banded_system(
        torch.from_numpy(means), torch.from_numpy(prec),
        mlpg.default_windows(3))
    jband, jrhs = jax_mlpg.build_banded_system(means, prec,
                                               jax_mlpg.default_windows(3))
    np.testing.assert_allclose(band.numpy(), np.asarray(jband), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(rhs.numpy(), np.asarray(jrhs), rtol=1e-6,
                               atol=1e-6)
    y = mlpg.banded_cholesky_solve(band, rhs)
    jy = jax_mlpg.banded_cholesky_solve(jband, jrhs)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
