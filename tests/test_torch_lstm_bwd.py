"""The port's BPTT against the JAX package: the plain reverse-time loop
(what ``lstm_bptt`` / ``lstm_dwh`` run on a CPU tensor) against
``_recurrence_bwd_pallas`` in interpret mode, the plain gate pre-pass
against the gates ``_lstm_bwd_kernel`` recomputes, and the autograd
Function's gradients against the flax scan, at the shapes of
tests/test_pallas_lstm.py.

Tolerance atol 2e-5, the gradient tolerance of tests/test_pallas_lstm.py
(float32 with another summation order; dW_h sums B*T terms).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.models.layers import LSTM as FlaxLSTM
from ensemble_svs_with_interactions_tpu.ops.pallas_lstm import (
    _recurrence_bwd_pallas,
    _recurrence_fwd_pallas,
)
from ensemble_svs_with_interactions_tpu_torch.models.layers import LSTM
from ensemble_svs_with_interactions_tpu_torch.ops.lstm_recurrence import (
    LSTMRecurrence,
    _shift,
    lstm_bptt,
    lstm_bptt_loop_reference,
    lstm_dwh,
    lstm_gates,
    lstm_gates_reference,
    lstm_recurrence_bwd_reference,
    lstm_recurrence_reference,
    lstm_recurrence_trainable,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    _lstm_arrays,
    flax_to_torch,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("B,T,H,chunk,b_blk,seed", [
    (2, 24, 8, 8, 2, 7),   # three time chunks
    (1, 13, 8, 13, 1, 9),  # the odd T
    (3, 16, 5, 4, 1, 3),   # three batch blocks, an H off the lane tiling
    (2, 8, 128, 4, 1, 5),  # a width the H > 64 kernels take
])
def test_plain_bptt_matches_pallas_interpret(B, T, H, chunk, b_blk, seed):
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(B, T, 4 * H)).astype(np.float32)
    w_h = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    dy = rng.normal(size=(B, T, H)).astype(np.float32)
    h, c = _recurrence_fwd_pallas(jnp.asarray(xw), jnp.asarray(w_h), chunk,
                                  b_blk, True)
    dxw_ref, dwh_ref = _recurrence_bwd_pallas(
        jnp.asarray(xw), jnp.asarray(w_h), h, c, jnp.asarray(dy), chunk,
        b_blk, True)
    args = tuple(_t(a) for a in (xw, w_h, h, c, dy))
    dxw, dwh = lstm_recurrence_bwd_reference(*args)
    np.testing.assert_allclose(dxw.numpy(), np.asarray(dxw_ref), atol=ATOL)
    np.testing.assert_allclose(dwh.numpy(), np.asarray(dwh_ref), atol=ATOL)
    # the wrappers take the plain versions for CPU tensors, uncounted
    before = (lstm_bptt.launches, lstm_dwh.launches)
    np.testing.assert_array_equal(lstm_bptt(*args).numpy(), dxw.numpy())
    np.testing.assert_allclose(lstm_dwh(args[2], dxw).numpy(), dwh.numpy(),
                               atol=ATOL)
    assert (lstm_bptt.launches, lstm_dwh.launches) == before


@pytest.mark.parametrize("B,T,H,seed", [
    (2, 24, 8, 7), (1, 13, 8, 9), (3, 16, 5, 3), (2, 9, 62, 4),
    (2, 5, 100, 5), (1, 4, 128, 6),
])
def test_plain_gates_match_jax_formula(B, T, H, seed):
    """The gate pre-pass's plain version against the gates
    ``_lstm_bwd_kernel`` recomputes (pallas_lstm.py:174-180): jax.nn.sigmoid
    and jnp.tanh of ``xw + hprev @ w_h``, hprev = h one step later."""
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(B, T, 4 * H)).astype(np.float32)
    w_h = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    h = rng.normal(size=(B, T, H)).astype(np.float32)
    hprev = jnp.concatenate([jnp.zeros((B, 1, H)), jnp.asarray(h)[:, :-1]],
                            axis=1)
    z = jnp.asarray(xw) + jnp.einsum("bth,hn->btn", hprev, jnp.asarray(w_h),
                                     preferred_element_type=jnp.float32)
    want = jnp.concatenate([jax.nn.sigmoid(z[..., 0 * H:1 * H]),
                            jax.nn.sigmoid(z[..., 1 * H:2 * H]),
                            jnp.tanh(z[..., 2 * H:3 * H]),
                            jax.nn.sigmoid(z[..., 3 * H:4 * H])], axis=-1)
    got = lstm_gates_reference(_t(xw), _t(w_h), _t(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = lstm_gates.launches
    np.testing.assert_array_equal(lstm_gates(_t(xw), _t(w_h), _t(h)).numpy(),
                                  got.numpy())
    assert lstm_gates.launches == before


def _bwd_reference_unsplit(xw, w_h, h, c, dy):
    """``lstm_recurrence_bwd_reference`` as one loop, before it was split
    into the gate pre-pass and the reverse loop."""
    B, T, H4 = xw.shape
    H = H4 // 4
    hprev, cprev = _shift(h), _shift(c)
    dxw = torch.empty_like(xw)
    dwh = torch.zeros_like(w_h)
    dh_next = xw.new_zeros(B, H)
    dc_next = xw.new_zeros(B, H)
    for t in range(T - 1, -1, -1):
        z = xw[:, t] + hprev[:, t] @ w_h
        zi, zf, zg, zo = z.split(H, dim=1)
        i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
        g = torch.tanh(zg)
        tc = torch.tanh(c[:, t])
        dh = dy[:, t] + dh_next
        dc = dh * o * (1.0 - tc * tc) + dc_next
        dz = torch.cat([dc * g * i * (1.0 - i),
                        dc * cprev[:, t] * f * (1.0 - f),
                        dc * i * (1.0 - g * g),
                        dh * tc * o * (1.0 - o)], dim=1)
        dxw[:, t] = dz
        dwh += hprev[:, t].t() @ dz
        dh_next = dz @ w_h.t()
        dc_next = dc * f
    return dxw, dwh


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("B,T,H,seed", [
    (2, 24, 8, 7), (3, 16, 5, 3), (4, 40, 62, 1), (2, 9, 64, 2), (1, 1, 3, 5),
    (2, 5, 100, 6), (1, 4, 128, 8),
])
def test_split_plain_bptt_composes_to_the_unsplit_loop(B, T, H, seed, dtype):
    """The gate pre-pass and the reverse loop, composed, give bitwise what
    the one-loop plain BPTT gave; so does ``lstm_bptt`` on a CPU tensor."""
    rng = np.random.default_rng(seed)
    xw = torch.from_numpy(rng.normal(size=(B, T, 4 * H)).astype(dtype))
    w_h = torch.from_numpy((rng.normal(size=(H, 4 * H)) / np.sqrt(H))
                           .astype(dtype))
    dy = torch.from_numpy(rng.normal(size=(B, T, H)).astype(dtype))
    h, c = lstm_recurrence_reference(xw, w_h, want_c=True)
    dxw_ref, dwh_ref = _bwd_reference_unsplit(xw, w_h, h, c, dy)
    dxw, dwh = lstm_recurrence_bwd_reference(xw, w_h, h, c, dy)
    assert torch.equal(dxw, dxw_ref) and torch.equal(dwh, dwh_ref)
    gates = lstm_gates_reference(xw, w_h, h)
    assert torch.equal(lstm_bptt_loop_reference(gates, w_h, c, dy), dxw_ref)
    assert torch.equal(lstm_bptt(xw, w_h, h, c, dy), dxw_ref)


def _flax_scan(x, params):
    H = params["hi"]["kernel"].shape[1]
    cell = nn.OptimizedLSTMCell(H)
    carry = (jnp.zeros((x.shape[0], H)), jnp.zeros((x.shape[0], H)))
    ys = []
    for t in range(x.shape[1]):
        carry, y = cell.apply({"params": params}, carry, x[:, t])
        ys.append(y)
    return jnp.stack(ys, axis=1)


@pytest.mark.parametrize("B,T,C,H,seed", [(2, 24, 6, 8, 7), (1, 13, 5, 8, 9)])
def test_function_gradients_match_flax_scan(B, T, C, H, seed):
    """Gradients with respect to x and every cell parameter (W_x, W_h and
    the bias, in the flax cell's per-gate layout) through
    ``lstm_recurrence_trainable``, against jax.grad of the flax scan."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    dy = rng.normal(size=(B, T, H)).astype(np.float32)
    cell = nn.OptimizedLSTMCell(H)
    params = cell.init(jax.random.PRNGKey(0),
                       (jnp.zeros((B, H)), jnp.zeros((B, H))),
                       jnp.asarray(x[:, 0]))["params"]

    def loss_ref(params, x):
        return jnp.sum(_flax_scan(x, params) * dy)

    val_ref, (gp, gx) = jax.value_and_grad(loss_ref, argnums=(0, 1))(
        params, jnp.asarray(x))
    w_x, w_h, b = (_t(a).requires_grad_(True) for a in _lstm_arrays(params))
    xt = _t(x).requires_grad_(True)
    y = lstm_recurrence_trainable(xt @ w_x + b, w_h)
    loss = (y * _t(dy)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(val_ref), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=ATOL)
    ref_wx, ref_wh, ref_b = _lstm_arrays(gp)
    np.testing.assert_allclose(w_x.grad.numpy(), ref_wx, atol=ATOL)
    np.testing.assert_allclose(w_h.grad.numpy(), ref_wh, atol=ATOL)
    np.testing.assert_allclose(b.grad.numpy(), ref_b, atol=ATOL)


def test_function_gradcheck_float64():
    rng = np.random.default_rng(1)
    B, T, H = 2, 7, 3
    xw = torch.from_numpy(rng.normal(size=(B, T, 4 * H))).requires_grad_(True)
    w_h = torch.from_numpy(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
    assert torch.autograd.gradcheck(LSTMRecurrence.apply,
                                    (xw, w_h.requires_grad_(True)))


@pytest.mark.parametrize("num_layers", [1, 2])
def test_bilstm_mixed_lengths_gradients_match_flax(num_layers):
    """Padding needs no mask in the backward: the layer zeroes its outputs
    at padded steps, so dy is 0 there, and padding is a suffix both ways.
    Gradients with respect to x and every parameter of a masked biLSTM
    with mixed lengths match the flax LSTM's, whose scan freezes its carry
    at padded steps."""
    B, T, C, H = 3, 20, 6, 5
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    w = rng.normal(size=(B, T, 2 * H)).astype(np.float32)
    lengths = np.array([20, 13, 4], np.int32)
    flax_lstm = FlaxLSTM(H, num_layers=num_layers, bidirectional=True)
    variables = flax_lstm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                               jnp.asarray(lengths))

    def loss_ref(params, x):
        return jnp.sum(flax_lstm.apply({"params": params}, x,
                                       jnp.asarray(lengths)) * w)

    gp, gx = jax.grad(loss_ref, argnums=(0, 1))(variables["params"],
                                                jnp.asarray(x))
    port = flax_to_torch(LSTM(C, H, num_layers=num_layers), variables)
    xt = _t(x).requires_grad_(True)
    out = port(xt, _t(lengths).long())
    assert any(type(f).__name__ == "LSTMRecurrenceBackward"
               for f in _graph_nodes(out.grad_fn))
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=ATOL)
    grads = flax_to_torch(LSTM(C, H, num_layers=num_layers),
                          {"params": gp})
    for name, p in port.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), dict(grads.named_parameters())[name]
            .detach().numpy(), atol=ATOL, err_msg=name)


def _graph_nodes(fn, seen=None):
    seen = set() if seen is None else seen
    if fn is None or fn in seen:
        return seen
    seen.add(fn)
    for nxt, _ in fn.next_functions:
        _graph_nodes(nxt, seen)
    return seen
