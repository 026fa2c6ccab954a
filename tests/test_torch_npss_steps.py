"""Training the deterministic NPSS cascade on the port against the JAX
package, on the CPU: one ``create_train_step`` step
(``tests/test_torch_trainer.assert_step_matches_jax``: the metrics at 1e-5
relative, every gradient within 1e-5 of its scale, the running statistics
after the step), at the tiny widths of ``tests/test_torch_npss_ar.py``
with one-layer stream decoders, dropout 0; and the plain BPTT (what
``lstm_bptt`` / ``lstm_dwh`` run on a CPU tensor) at the widths the
hand-written 512 < H <= 1024 kernel takes, H = 640 and 1024, against the
JAX package's ``_recurrence_bwd_pallas`` in interpret mode at 2e-5 (the
tolerance of ``tests/test_torch_lstm_bwd.py``).

The cascade's loss sums the coarse and fine outputs of its Post-Net
decoders and adds ``pitch_reg_weight`` times the lf0 residual's loss.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.ops.pallas_lstm import (
    _recurrence_bwd_pallas,
    _recurrence_fwd_pallas,
)
from ensemble_svs_with_interactions_tpu_torch.ops.lstm_recurrence import (
    lstm_bptt,
    lstm_dwh,
    lstm_recurrence_bwd_reference,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    torch_to_flax,
)
from tests.test_torch_npss_ar import cascade_config
from tests.test_torch_trainer import assert_step_matches_jax

BPTT_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def step_batch(cfg, seed=0, B=3, T=23):
    """Mixed lengths over an odd T, targets around the streams' scale, a
    vuv stream of zeros and ones, the pitch regularization's weights."""
    rng = np.random.default_rng(seed)
    out = rng.normal(size=(B, T, sum(cfg["stream_sizes"]))).astype(
        np.float32)
    out[..., 9] = rng.uniform(size=(B, T)) > 0.3
    x = rng.uniform(0, 1, (B, T, cfg["netG"]["in_dim"])).astype(np.float32)
    return {"in_feats": x, "out_feats": out,
            "lengths": np.array([T, T - 6, T - 11], np.int32),
            "pitch_reg_dyn_ws": rng.uniform(0, 1, (B, T, 1)).astype(
                np.float32)}


def ar_step_config():
    """The AR cascade with one-layer stream decoders and Post-Nets: the
    JAX step's three compiles (init, evaluation, step) shrink, and the
    layer boundaries are held by ``tests/test_torch_npss_ar.py``."""
    cfg = cascade_config(vuv_bap=False)
    for name in ("mgc_model", "bap_model"):
        cfg["netG"][name].update(decoder_layers=1, postnet_layers=1)
    return cfg


def test_train_step_matches_jax():
    """One step of the AR cascade with the pitch regularization on, both
    from the port's flax-scheme weights (the JAX ``init`` of this cascade
    alone takes over half a minute to compile)."""
    cfg = ar_step_config()
    variables = torch_to_flax(init_module(instantiate(cfg["netG"])))
    assert_step_matches_jax(cfg, dict(pitch_reg_weight=1.0), step_batch(cfg),
                            variables)


@pytest.mark.parametrize("B,T,H,seed", [(2, 3, 640, 1), (1, 2, 1024, 2)])
def test_plain_bptt_matches_pallas_interpret_wide(B, T, H, seed):
    """dxw and dW_h of the plain loop against the Pallas backward, and
    the wrappers' CPU path (the plain versions, no launch counted)."""
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(B, T, 4 * H)).astype(np.float32)
    w_h = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    dy = rng.normal(size=(B, T, H)).astype(np.float32)
    h, c = _recurrence_fwd_pallas(jnp.asarray(xw), jnp.asarray(w_h), T, B,
                                  True)
    dxw_ref, dwh_ref = _recurrence_bwd_pallas(
        jnp.asarray(xw), jnp.asarray(w_h), h, c, jnp.asarray(dy), T, B, True)
    args = tuple(torch.from_numpy(np.array(a)) for a in (xw, w_h, h, c, dy))
    dxw, dwh = lstm_recurrence_bwd_reference(*args)
    np.testing.assert_allclose(dxw.numpy(), np.asarray(dxw_ref),
                               atol=BPTT_ATOL)
    np.testing.assert_allclose(dwh.numpy(), np.asarray(dwh_ref),
                               atol=BPTT_ATOL)
    before = (lstm_bptt.launches, lstm_dwh.launches)
    np.testing.assert_array_equal(lstm_bptt(*args).numpy(), dxw.numpy())
    assert (lstm_bptt.launches, lstm_dwh.launches) == before
