"""Port's LSTM recurrence and LSTM layer against the JAX package.

The port's plain recurrence (what ``lstm_recurrence`` runs on a CPU
tensor) is held against the Pallas kernel in interpret mode and the flax
cell scan, at the shapes and tolerances of tests/test_pallas_lstm.py
(atol 1e-5: float32 with another summation order).  The kernel itself
runs only on the card: tests/test_torch_kernels_cuda.py.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.models.layers import LSTM as FlaxLSTM
from ensemble_svs_with_interactions_tpu.ops.pallas_lstm import (
    _recurrence_fwd_pallas,
    extract_flax_lstm_weights,
    lstm_layer_pallas,
)
from ensemble_svs_with_interactions_tpu.ops.pallas_lstm import (
    lstm_recurrence as pallas_recurrence,
)
from ensemble_svs_with_interactions_tpu_torch.models.layers import LSTM
from ensemble_svs_with_interactions_tpu_torch.ops.lstm_recurrence import (
    lstm_recurrence,
    lstm_recurrence_reference,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

ATOL = 1e-5


def _flax_cell_scan(x, params):
    H = params["hi"]["kernel"].shape[1]
    cell = nn.OptimizedLSTMCell(H)
    carry = (jnp.zeros((x.shape[0], H)), jnp.zeros((x.shape[0], H)))
    ys = []
    for t in range(x.shape[1]):
        carry, y = cell.apply({"params": params}, carry, x[:, t])
        ys.append(y)
    return np.asarray(jnp.stack(ys, axis=1))


@pytest.mark.parametrize("B,T,C,H,seed", [(2, 32, 12, 8, 0), (2, 29, 12, 8, 1)])
def test_plain_recurrence_matches_pallas_and_flax_scan(B, T, C, H, seed):
    x = np.random.default_rng(seed).normal(size=(B, T, C)).astype(np.float32)
    cell = nn.OptimizedLSTMCell(H)
    carry0 = (jnp.zeros((B, H)), jnp.zeros((B, H)))
    params = cell.init(jax.random.PRNGKey(0), carry0, jnp.asarray(x[:, 0]))[
        "params"]
    pallas = np.asarray(lstm_layer_pallas(jnp.asarray(x), params, chunk=16,
                                          interpret=True))
    scan = _flax_cell_scan(jnp.asarray(x), params)

    w_x, w_h, b = (torch.from_numpy(np.array(a))
                   for a in extract_flax_lstm_weights(params))
    got = lstm_recurrence(torch.from_numpy(x) @ w_x + b, w_h).numpy()
    assert got.shape == (B, T, H)
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, scan, atol=ATOL)


def test_want_c_matches_pallas_forward_kernel():
    """``want_c`` is the counterpart of ``_lstm_fwd_kernel``: the same h
    sequence plus the cell-state sequence."""
    B, T, H = 2, 24, 8
    rng = np.random.default_rng(7)
    xw = rng.normal(size=(B, T, 4 * H)).astype(np.float32)
    w_h = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    h_ref, c_ref = _recurrence_fwd_pallas(jnp.asarray(xw), jnp.asarray(w_h),
                                          8, 2, True)
    h, c = lstm_recurrence(torch.from_numpy(xw), torch.from_numpy(w_h),
                           want_c=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=ATOL)
    np.testing.assert_array_equal(
        lstm_recurrence(torch.from_numpy(xw), torch.from_numpy(w_h)).numpy(),
        h.numpy())


@pytest.mark.parametrize("want_c", [False, True])
def test_plain_recurrence_matches_pallas_above_512(want_c):
    """The plain loop that the card holds its 512 < H <= 1024 kernel
    against, at H = 520: h against ``_lstm_kernel``, h and c against
    ``_lstm_fwd_kernel``, both in interpret mode."""
    B, T, H = 3, 9, 520
    rng = np.random.default_rng(11)
    xw = rng.normal(size=(B, T, 4 * H)).astype(np.float32)
    w_h = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    got = lstm_recurrence_reference(torch.from_numpy(xw),
                                    torch.from_numpy(w_h), want_c)
    if want_c:
        ref = _recurrence_fwd_pallas(jnp.asarray(xw), jnp.asarray(w_h), T, B,
                                     True)
    else:
        got, ref = (got,), (pallas_recurrence(jnp.asarray(xw),
                                              jnp.asarray(w_h), chunk=T,
                                              interpret=True),)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_bidirectional_lstm_mixed_lengths(num_layers):
    """Carry through padding: the port's recurrence runs on through the
    padded suffix, the flax scan freezes its carry there.  Both agree on
    valid steps (the backward direction is reversed within each length,
    so padding is a suffix both ways) and the layer zeroes the rest."""
    B, T, C, H = 3, 20, 6, 5
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    lengths = np.array([20, 13, 4], np.int32)
    flax_lstm = FlaxLSTM(H, num_layers=num_layers, bidirectional=True)
    variables = flax_lstm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                               jnp.asarray(lengths))
    ref = np.asarray(flax_lstm.apply(variables, jnp.asarray(x),
                                     jnp.asarray(lengths)))

    port = flax_to_torch(LSTM(C, H, num_layers=num_layers), variables)
    got = port(torch.from_numpy(x), torch.from_numpy(lengths).long())
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=ATOL)
    assert not got[1, 13:].any() and not got[2, 4:].any()


def test_recurrence_launches_or_raises_off_cpu():
    """No fallback: a tensor that is not on the CPU never takes the plain
    version, and the plain version never counts as a launch."""
    before = lstm_recurrence.launches
    lstm_recurrence(torch.zeros(1, 3, 8), torch.zeros(2, 8))
    assert lstm_recurrence.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_recurrence(torch.zeros(1, 3, 8, device="meta"),
                        torch.zeros(2, 8, device="meta"))
