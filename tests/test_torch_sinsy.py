"""The single-track recipe's timing and acoustic models on the port against
the JAX package, on the CPU, at tiny widths: ``MDN`` and ``MDNv2``
(``models/generic.py``), ``ResSkipF0FFConvLSTM`` (``models/acoustic/
sinsy.py``) and its residual-F0 helpers (``models/acoustic/util.py``).

Weights are the port's, drawn by ``utils/flax_init`` and carried to the
JAX twin with ``torch_to_flax`` (batch statistics perturbed away from
their initial values); inputs are seeded NumPy arrays with mixed lengths.
Outputs at ATOL (float32 on both sides in other summation orders); one
train step of each model through ``tests/test_torch_trainer.
assert_step_matches_jax`` (metrics at 1e-5 relative, gradients within
1e-5 of their scale), dropout 0 since masks cannot match across
frameworks.  The flax-scheme templates equal the JAX ``init``'s structure,
traced by ``jax.eval_shape``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.models.acoustic import (
    util as jax_util,
)
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.base import PredictionType
from ensemble_svs_with_interactions_tpu_torch.models import MDN, MDNv2
from ensemble_svs_with_interactions_tpu_torch.models.acoustic import (
    ResSkipF0FFConvLSTM,
)
from ensemble_svs_with_interactions_tpu_torch.models.acoustic import util
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
    init_variables,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    torch_to_flax,
)
from tests.test_torch_trainer import assert_step_matches_jax

ATOL = 1e-5
B, T = 3, 24
LENGTHS = np.array([T, T - 7, T - 13])
PKG = "ensemble_svs_with_interactions_tpu.models"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def mdn_config(cls="MDNv2", dim_wise=False, dropout=0.5):
    net = {"_target_": f"{PKG}.{cls}", "in_dim": 12, "hidden_dim": 8,
           "out_dim": 2, "num_layers": 3, "num_gaussians": 3,
           "dim_wise": dim_wise, "init_type": "kaiming_normal"}
    if cls == "MDNv2":
        net["dropout"] = dropout
    return {"netG": net, "stream_sizes": [2], "has_dynamic_features":
            [False], "num_windows": 1}


def resskip_config(use_mdn=False, skip_inputs=False, dropout=0.1):
    """``acoustic_resf0convlstm.yaml`` at tiny widths: 86 inputs, streams
    8 + 1 + 1 + 3, the lf0 statistics filled in as the runner fills
    them."""
    net = {"_target_": f"{PKG}.acoustic.ResSkipF0FFConvLSTM", "in_dim": 86,
           "out_dim": 13, "ff_hidden_dim": 8, "conv_hidden_dim": 6,
           "lstm_hidden_dim": 4, "num_lstm_layers": 2, "dropout": dropout,
           "in_lf0_idx": 51, "out_lf0_idx": 8, "skip_inputs": skip_inputs,
           "in_lf0_min": 5.2, "in_lf0_max": 6.6, "out_lf0_mean": 5.9,
           "out_lf0_scale": 0.25, "use_mdn": use_mdn, "num_gaussians": 2,
           "init_type": "xavier_normal"}
    return {"netG": net, "stream_sizes": [8, 1, 1, 3],
            "has_dynamic_features": [False] * 4, "num_windows": 1}


def inputs(in_dim, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, T, in_dim)).astype(np.float32)
    x[:, T - 13:] *= (np.arange(T)[None, T - 13:, None]
                      < LENGTHS[:, None, None])
    return x


def twins(cfg, seed=0):
    """(port module, JAX module, JAX variables): the port's flax-scheme
    weights, running statistics perturbed, carried to JAX."""
    module = init_module(instantiate(cfg["netG"]), seed=seed)
    rng = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=rng) * 0.3)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=rng) + 0.5)
    return module.eval(), jax_instantiate(cfg["netG"]), torch_to_flax(module)


def _close(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    w = np.asarray(want)
    g = got.detach().numpy()
    assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


MDN_CASES = [("MDN", False), ("MDN", True), ("MDNv2", False),
             ("MDNv2", True)]


@pytest.mark.parametrize("cls,dim_wise", MDN_CASES)
def test_mdn_models_match_jax(cls, dim_wise):
    """Forward (log_pi, log_sigma, mu) and ``inference`` (mu, sigma)."""
    cfg = mdn_config(cls, dim_wise)
    module, jm, variables = twins(cfg)
    assert module.prediction_type() == PredictionType.PROBABILISTIC
    x = inputs(12)
    lengths = torch.from_numpy(LENGTHS)
    with torch.no_grad():
        _close(module(torch.from_numpy(x), lengths), jm.apply(variables, x))
        _close(module.inference(torch.from_numpy(x), lengths),
               jm.apply(variables, x, method=jm.inference))


def test_mdnv2_dropout_trains_only():
    """MDNv2's dropout applies in training alone, at rate ``dropout``."""
    module = init_module(instantiate(mdn_config("MDNv2", dropout=0.5)
                                     ["netG"]))
    x = torch.from_numpy(inputs(12))
    with torch.no_grad():
        a = module(x, train=False)
        b = module(x, train=False)
        c = module(x, train=True, generator=torch.Generator().manual_seed(0))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.allclose(a[2], c[2])
    with pytest.raises(ValueError, match="Generator"):
        module(x, train=True)


RESSKIP_CASES = [(False, False), (False, True), (True, True)]


@pytest.mark.parametrize("use_mdn,skip_inputs", RESSKIP_CASES)
def test_resskip_matches_jax(use_mdn, skip_inputs):
    """Evaluation forward ((prediction, lf0 residual)) and ``inference``
    with mixed lengths; then a training forward (dropout 0): its outputs
    and the batch norms' updated running statistics."""
    cfg = resskip_config(use_mdn, skip_inputs, dropout=0.0)
    module, jm, variables = twins(cfg)
    assert module.has_residual_lf0_prediction() and \
        jm.has_residual_lf0_prediction()
    assert module.prediction_type() == (
        PredictionType.PROBABILISTIC if use_mdn
        else PredictionType.DETERMINISTIC)
    x = inputs(86, seed=1)
    xt, lengths = torch.from_numpy(x), torch.from_numpy(LENGTHS)
    with torch.no_grad():
        _close(module(xt, lengths), jm.apply(variables, x, LENGTHS))
        _close(module.inference(xt, lengths),
               jm.apply(variables, x, LENGTHS, method=jm.inference))
        got = module(xt, lengths, train=True,
                     generator=torch.Generator().manual_seed(0))
    want, updates = jm.apply(variables, x, LENGTHS, train=True,
                             mutable=["batch_stats"])
    _close(got, want)
    stats = torch_to_flax(module)["batch_stats"]
    flat = jax.tree_util.tree_leaves_with_path(updates["batch_stats"])
    for path, value in flat:
        node = stats
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(value), rtol=0,
                                   atol=ATOL, err_msg=str(path))


def test_resskip_replaces_the_lf0_column():
    """The prediction's lf0 column is the normalized score lf0 plus the
    tanh-bounded residual (at most 600 cents); the other columns are the
    head's."""
    cfg = resskip_config()
    module = init_module(instantiate(cfg["netG"])).eval()
    x = torch.from_numpy(inputs(86, seed=2))
    with torch.no_grad():
        mu, residual = module(x)
    net = cfg["netG"]
    score = x[:, :, 51:52] * (net["in_lf0_max"] - net["in_lf0_min"]) \
        + net["in_lf0_min"]
    want = (score + residual - net["out_lf0_mean"]) / net["out_lf0_scale"]
    torch.testing.assert_close(mu[:, :, 8:9], want, rtol=0, atol=1e-6)
    assert residual.abs().max() <= 600 * np.log(2) / 1200
    assert residual.shape == (B, T, 1)


@pytest.mark.parametrize("ndim", [3, 4])
def test_residual_helpers_match_jax(ndim):
    """``predict_lf0_with_residual`` and ``set_lf0_column`` on (B, T, D)
    and MDN means (B, T, G, D), and ``concat_stream_outputs`` with a
    Post-Net list."""
    rng = np.random.default_rng(ndim)
    x = rng.uniform(0, 1, (B, T, 20)).astype(np.float32)
    out = rng.normal(size=(B, T, 2, 7) if ndim == 4 else (B, T, 7)).astype(
        np.float32)
    args = (4, 5.0, 6.5, 3, 5.8, 0.3)
    got = util.predict_lf0_with_residual(torch.from_numpy(x),
                                         torch.from_numpy(out), *args)
    want = jax_util.predict_lf0_with_residual(x, jnp.asarray(out), *args)
    _close(got, want)
    _close(util.set_lf0_column(torch.from_numpy(out), got[0], 3),
           jax_util.set_lf0_column(jnp.asarray(out), want[0], 3))
    parts = [rng.normal(size=(B, T, 2)).astype(np.float32),
             [rng.normal(size=(B, T, 3)).astype(np.float32)] * 2]
    _close(util.concat_stream_outputs(
        [torch.from_numpy(parts[0]), [torch.from_numpy(p)
                                      for p in parts[1]]], 5),
        jax_util.concat_stream_outputs(
            [jnp.asarray(parts[0]), [jnp.asarray(p) for p in parts[1]]], 5))


def test_residual_is_float32_under_bf16():
    """Under AMP the residual and the predicted lf0 are summed in float32
    (the JAX package's float64 ratio promotes them) and the lf0 column is
    rounded to the output's bf16."""
    x = torch.rand(2, 5, 10).to(torch.bfloat16)
    out = torch.randn(2, 5, 4).to(torch.bfloat16)
    lf0, residual = util.predict_lf0_with_residual(x, out, 1, 5.0, 6.5, 2,
                                                   5.8, 0.3)
    assert lf0.dtype == residual.dtype == torch.float32
    assert util.set_lf0_column(out, lf0, 2).dtype == torch.bfloat16
    jlf0, jres = jax_util.predict_lf0_with_residual(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(out.float().numpy(), jnp.bfloat16), 1, 5.0, 6.5, 2, 5.8,
        0.3)
    assert jlf0.dtype == jres.dtype == jnp.float32
    np.testing.assert_allclose(lf0.numpy(), np.asarray(jlf0), rtol=0,
                               atol=1e-5)


TEMPLATE_CASES = {
    "MDNv2": mdn_config()["netG"],
    "MDN": mdn_config("MDN", True)["netG"],
    "ResSkip": resskip_config()["netG"],
    "ResSkip_mdn_skip": resskip_config(True, True)["netG"],
}


@pytest.mark.parametrize("case", sorted(TEMPLATE_CASES))
def test_flax_init_templates_match_jax(case):
    """``init_variables`` gives the JAX ``init``'s tree (every path and
    shape, params and batch statistics), so the runner's stage 6 restores
    a JAX checkpoint onto it; the kernels the JAX model draws with its
    ``init_type`` follow that scheme."""
    net = TEMPLATE_CASES[case]
    module = instantiate(net)
    got = init_variables(module, seed=0)
    jm = jax_instantiate(net)
    in_dim = net["in_dim"]
    want = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 8, in_dim)), jnp.array([8])))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(want))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), got) == shapes
    kernel = got["params"]["Dense_0"]["kernel"]
    fan_in = kernel.shape[0]
    scale = {"kaiming_normal": 2.0 / fan_in,
             "xavier_normal": 2.0 / (fan_in + kernel.shape[1])}[
        net["init_type"]]
    assert 0.5 < kernel.var() / scale < 1.5


def test_one_target_builds_both_twins():
    """The JAX ``_target_`` paths resolve to the port's classes."""
    assert isinstance(instantiate(mdn_config("MDN")["netG"]), MDN)
    assert isinstance(instantiate(mdn_config()["netG"]), MDNv2)
    assert isinstance(instantiate(resskip_config()["netG"]),
                      ResSkipF0FFConvLSTM)


def one_layer(cfg):
    """One LSTM layer: the step's JAX compile halves, and the layer
    boundary is held by ``test_resskip_matches_jax``."""
    cfg["netG"]["num_lstm_layers"] = 1
    return cfg


STEP_CASES = {
    "mdnv2": (mdn_config(dropout=0.0), dict(pitch_reg_weight=0.0)),
    "resskip": (one_layer(resskip_config(dropout=0.0)),
                dict(pitch_reg_weight=1.0)),
    "resskip_mdn": (one_layer(resskip_config(True, True, dropout=0.0)),
                    dict(pitch_reg_weight=1.0)),
}


def step_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    net = cfg["netG"]
    out = rng.normal(size=(B, T, sum(cfg["stream_sizes"]))).astype(
        np.float32)
    batch = {"in_feats": inputs(net["in_dim"], seed),
             "out_feats": out, "lengths": LENGTHS.astype(np.int32)}
    if "in_lf0_idx" in net:
        batch["pitch_reg_dyn_ws"] = rng.uniform(
            0, 1, (B, T, 1)).astype(np.float32)
    return batch


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    """One single-track train step: the MDN loss for MDNv2; the feature
    loss plus ``pitch_reg_weight`` times the residual lf0's loss for
    ResSkip (linear and MDN heads)."""
    cfg, kw = STEP_CASES[case]
    assert_step_matches_jax(cfg, kw, step_batch(cfg))
