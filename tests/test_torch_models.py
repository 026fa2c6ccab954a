"""Port's flagship models against the JAX package, weights carried over
with ``flax_to_torch``, at tiny dims.

Tolerance: atol 1e-4 on outputs of O(1) magnitude.  Both sides compute in
float32; the port sums matmuls and the LSTM gate products in another order
than XLA, and LayerNorm's variance is two-pass in torch and E[x^2]-E[x]^2
in flax, so outputs differ at the 1e-6 level and 1e-4 leaves room for
what a few stacked layers accumulate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.models.tacotron import (
    prenet_dropout_scales,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    instantiate as torch_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

ATOL = 1e-4
PKG = "ensemble_svs_with_interactions_tpu.models"


def _randomize_batch_stats(variables, seed):
    """Non-trivial running statistics, so the BatchNorm mapping is tested."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v)
            elif k == "var":
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            else:
                out[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
        return out

    variables = dict(variables)
    if "batch_stats" in variables:
        variables["batch_stats"] = walk(variables["batch_stats"])
    return variables


def _twins(cfg, init_args, seed=0):
    jax_module = jax_instantiate(cfg)
    variables = jax_module.init(
        {"params": jax.random.PRNGKey(seed), "prenet": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, *init_args)
    variables = _randomize_batch_stats(
        jax.tree_util.tree_map(np.asarray, variables), seed)
    port = flax_to_torch(torch_instantiate(cfg), variables).eval()
    return jax_module, variables, port


def _t(a):
    return torch.from_numpy(np.array(a))


def _lengths(B, T):
    return np.array([T] + [max(T - 7 * (i + 1), 3) for i in range(B - 1)],
                    np.int32)


@pytest.mark.parametrize("use_mdn", [False, True])
def test_ffconvlstm(use_mdn):
    cfg = {"_target_": f"{PKG}.FFConvLSTM", "in_dim": 10, "ff_hidden_dim": 8,
           "conv_hidden_dim": 8, "lstm_hidden_dim": 4, "num_lstm_layers": 2,
           "out_dim": 3, "use_mdn": use_mdn, "num_gaussians": 2}
    B, T = 3, 24
    x = np.random.default_rng(0).normal(size=(B, T, 10)).astype(np.float32)
    lengths = _lengths(B, T)
    jm, v, port = _twins(cfg, (jnp.asarray(x), jnp.asarray(lengths)))
    ref = jm.apply(v, jnp.asarray(x), jnp.asarray(lengths),
                   method="inference")
    with torch.no_grad():
        got = port.inference(_t(x), _t(lengths).long())
    if use_mdn:
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_multitrack_lstm_encoder():
    cfg = {"_target_": f"{PKG}.MultiTrackLSTMEncoder", "in_dim": 20,
           "hidden_dim": 5, "out_dim": 7, "num_layers": 2,
           "in_ph_start_idx": 3, "in_ph_end_idx": 12, "embed_dim": 6}
    B, T = 3, 22
    rng = np.random.default_rng(1)
    xm, xs = (rng.normal(size=(B, T, 20)).astype(np.float32)
              for _ in range(2))
    sm, ss = (rng.normal(size=(B, T, 6)).astype(np.float32) for _ in range(2))
    lengths = _lengths(B, T)
    args = (jnp.asarray(xm), jnp.asarray(xs),
            (jnp.asarray(sm), jnp.asarray(ss)), jnp.asarray(lengths))
    jm, v, port = _twins(cfg, args)
    ref = jm.apply(v, *args)
    with torch.no_grad():
        got = port(_t(xm), _t(xs), (_t(sm), _t(ss)), _t(lengths).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("multitrack", [True, False])
def test_variance_predictor_mdn(multitrack):
    """The timing models: MultiTrackVariancePredictor (two note-merged
    tracks plus two speaker embeddings) and the single-track
    VariancePredictor, both with an MDN head."""
    cfg = {"in_dim": 10, "out_dim": 3, "num_layers": 2, "hidden_dim": 8,
           "kernel_size": 3, "use_mdn": True, "num_gaussians": 2}
    B, T = 2, 16
    rng = np.random.default_rng(2)
    lengths = np.array([T, T], np.int32)
    if multitrack:
        cfg.update({"_target_": f"{PKG}.MultiTrackVariancePredictor",
                    "num_speaker": 3, "spk_embed_dim": 2})
        x = rng.normal(size=(B, T, 20)).astype(np.float32)
        spks = (np.array([0, 2]), np.array([1, 0]))
        jax_args = (jnp.asarray(x), tuple(jnp.asarray(s) for s in spks),
                    jnp.asarray(lengths))
        port_args = (_t(x), tuple(_t(s) for s in spks), _t(lengths).long())
    else:
        cfg.update({"_target_": f"{PKG}.VariancePredictor"})
        x = rng.normal(size=(B, T, 10)).astype(np.float32)
        jax_args = (jnp.asarray(x), jnp.asarray(lengths))
        port_args = (_t(x), _t(lengths).long())
    jm, v, port = _twins(cfg, jax_args)
    mu_ref, sigma_ref = jm.apply(v, *jax_args, method="inference")
    with torch.no_grad():
        mu, sigma = port.inference(*port_args)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_ref), atol=ATOL)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_ref),
                               atol=ATOL)


def test_ar_lf0_decoder_no_dropout():
    """The AR residual-F0 decoder, free-running, over 16 reduced steps
    (64 frames, r = 4) at tiny dims with prenet_dropout = 0: short and
    small enough that the loop does not amplify float32 rounding."""
    cfg = {"_target_": f"{PKG}.acoustic.MultiTrackBiLSTMResF0NonAttentiveDecoder",
           "in_dim": 20, "out_dim": 1, "ff_hidden_dim": 8,
           "conv_hidden_dim": 8, "lstm_hidden_dim": 4, "num_lstm_layers": 2,
           "decoder_layers": 2, "decoder_hidden_dim": 8, "prenet_layers": 0,
           "prenet_dropout": 0.0, "zoneout": 0.0, "reduction_factor": 4,
           "downsample_by_conv": True, "in_lf0_idx": 15, "out_lf0_idx": 0,
           "in_lf0_min": 4.5, "in_lf0_max": 6.5,
           "out_lf0_mean": float(np.log(220.0)), "out_lf0_scale": 0.1,
           "in_ph_start_idx": 3, "in_ph_end_idx": 12, "embed_dim": 6}
    B, T = 2, 62  # pads to 64 frames = 16 reduced steps
    rng = np.random.default_rng(4)
    xm, xs = (rng.uniform(size=(B, T, 20)).astype(np.float32)
              for _ in range(2))
    em, es = (rng.normal(0, 0.1, size=(B, T, 6)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([T, 50], np.int32)
    args = tuple(jnp.asarray(a) for a in (xm, xs, em, es, lengths))
    jm, v, port = _twins(cfg, args)
    ref = jm.apply(v, *args, method="inference",
                   rngs={"prenet": jax.random.PRNGKey(5)})
    with torch.no_grad():
        got = port.inference(_t(xm), _t(xs), _t(em), _t(es),
                             _t(lengths).long())
    assert got.shape == (B, T, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_prenet_dropout_keep_rate_and_scale():
    """Port only: torch cannot reproduce jax.random's bits, so the
    inference-time prenet dropout is checked for what it must be, a
    Bernoulli keep with probability 1 - p scaled by 1 / (1 - p), drawn
    reproducibly from a seeded generator."""
    p = 0.5
    g = torch.Generator().manual_seed(0)
    s = prenet_dropout_scales((200, 4, 25), p, g, "cpu")
    assert set(torch.unique(s).tolist()) == {0.0, 2.0}
    assert abs((s > 0).float().mean().item() - (1 - p)) < 0.01
    again = prenet_dropout_scales((200, 4, 25), p,
                                  torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(s, again)
    assert torch.equal(
        prenet_dropout_scales((3, 2), 0.0, g, "cpu"), torch.ones(3, 2))


def test_flax_to_torch_rejects_mismatched_tree():
    cfg = {"_target_": f"{PKG}.SpeakerEmbedding", "num_embeddings": 3,
           "embedding_dim": 4}
    port = torch_instantiate(cfg)
    table = np.ones((3, 4), np.float32)
    flax_to_torch(port, {"params": {"Embed_0": {"embedding": table}}})
    np.testing.assert_array_equal(port.Embed_0.weight.detach().numpy(), table)
    with pytest.raises(ValueError, match="unmatched"):
        flax_to_torch(port, {"params": {"Embed_0": {"embedding": table},
                                        "extra": {"kernel": table}}})
