"""The rest of the acoustic model zoo on the port against the JAX package,
on the CPU, at tiny widths: ``FFN``, ``LSTMRNN``, ``RMDN``,
``LSTMRNNSAR`` and ``Conv1dResnetSAR`` with their FIR analysis filters
(``models/layers.TrTimeInvFIRFilter``), ``TransformerEncoder`` with its
relative-position attention (``models/generic.py``),
``ResF0VariancePredictor`` and ``ResF0TransformerEncoder``
(``models/acoustic/resf0.py``), ``WaveNet`` (``models/wavenet.py``) and
``MultiTrackMultistreamSeparateF0ParametricModelv3``.

Weights are the port's, drawn by ``utils/flax_init`` and carried to the
JAX twin with ``torch_to_flax``; inputs are seeded NumPy arrays with mixed
lengths and odd T.  Outputs at ATOL (float32 on both sides in other
summation orders); one single-track train step of each model through
``tests/test_torch_trainer.assert_step_matches_jax`` (metrics at 1e-5
relative, gradients within 1e-5 of their scale), the shallow-AR models'
through the step's ``preprocess_target`` branch; the v3 model through one
multitrack SGD step.  Dropout 0 where a training forward is compared:
masks cannot match across frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.models import layers as jax_layers
from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
from ensemble_svs_with_interactions_tpu.train import multitrack as jax_mt
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.base import PredictionType
from ensemble_svs_with_interactions_tpu_torch.models import generic
from ensemble_svs_with_interactions_tpu_torch.models.layers import (
    TrTimeInvFIRFilter,
)
from ensemble_svs_with_interactions_tpu_torch.train import loop
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
    init_variables,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)
from tests.test_torch_trainer import assert_step_matches_jax

ATOL = 1e-5
B, T = 3, 23
LENGTHS = np.array([T, T - 6, T - 11])
PKG = "ensemble_svs_with_interactions_tpu.models"
IN = 12


def inputs(in_dim=IN, seed=0, T=T, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, T, in_dim)).astype(np.float32)
    return x * (np.arange(T)[None, :, None] < lengths[:, None, None])


def _close(got, want, atol=ATOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    w = np.asarray(want)
    g = got.detach().numpy()
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def twins(net, seed=0):
    """(port module, JAX module, JAX variables): the port's flax-scheme
    weights carried to JAX."""
    module = init_module(instantiate(net), seed=seed).eval()
    return module, jax_instantiate(net), torch_to_flax(module)


# ------------------------------------------------------------- the configs
def ffn(**kw):
    return {"_target_": f"{PKG}.FFN", "in_dim": IN, "hidden_dim": 8,
            "out_dim": 5, "num_layers": 2, "dropout": 0.0,
            "init_type": "kaiming_normal", **kw}


def lstmrnn(**kw):
    return {"_target_": f"{PKG}.LSTMRNN", "in_dim": IN, "hidden_dim": 6,
            "out_dim": 5, "num_layers": 2, "init_type": "xavier_normal",
            **kw}


def rmdn(**kw):
    return {"_target_": f"{PKG}.RMDN", "in_dim": IN, "hidden_dim": 6,
            "out_dim": 3, "num_gaussians": 2, "init_type": "normal", **kw}


SAR_STREAMS = {"stream_sizes": [3, 1, 2], "ar_orders": [2, 4, 1]}


def lstmrnn_sar(**kw):
    return {"_target_": f"{PKG}.LSTMRNNSAR", "in_dim": IN, "hidden_dim": 6,
            "out_dim": 6, "num_layers": 1, **SAR_STREAMS, **kw}


def conv_sar(**kw):
    return {"_target_": f"{PKG}.Conv1dResnetSAR", "in_dim": IN,
            "hidden_dim": 6, "out_dim": 6, "num_layers": 2, **SAR_STREAMS,
            **kw}


def transformer(**kw):
    return {"_target_": f"{PKG}.TransformerEncoder", "in_dim": IN,
            "out_dim": 5, "hidden_dim": 8, "attention_dim": 6,
            "num_heads": 2, "num_layers": 2, "kernel_size": 3,
            "dropout": 0.0, **kw}


LF0 = {"in_lf0_idx": 4, "in_lf0_min": 5.2, "in_lf0_max": 6.6,
       "out_lf0_idx": 2, "out_lf0_mean": 5.9, "out_lf0_scale": 0.25}


def resf0_vp(**kw):
    return {"_target_": f"{PKG}.acoustic.ResF0VariancePredictor",
            "in_dim": IN, "out_dim": 5, "num_layers": 2, "hidden_dim": 6,
            "kernel_size": 3, "dropout": 0.0, "init_type": "kaiming_normal",
            **LF0, **kw}


def resf0_transformer(**kw):
    return {"_target_": f"{PKG}.acoustic.ResF0TransformerEncoder",
            "in_dim": IN, "out_dim": 5, "hidden_dim": 8, "attention_dim": 6,
            "num_layers": 1, "dropout": 0.0, **LF0, **kw}


def wavenet(**kw):
    return {"_target_": f"{PKG}.wavenet.WaveNet", "in_dim": IN,
            "out_dim": 4, "layers": 3, "stacks": 1, "residual_channels": 6,
            "gate_channels": 8, "skip_out_channels": 5, **kw}


# --------------------------------------------------------------- modules
PLAIN = {
    "ffn": ffn(),
    "ffn_sigmoid": ffn(last_sigmoid=True, num_layers=1),
    "lstmrnn": lstmrnn(),
    "lstmrnn_unidirectional": lstmrnn(bidirectional=False, num_layers=1),
    "rmdn": rmdn(),
    "rmdn_dim_wise": rmdn(dim_wise=True, num_layers=2),
}


@pytest.mark.parametrize("case", sorted(PLAIN))
def test_plain_models_match_jax(case):
    """Forward (an MDN head's (log_pi, log_sigma, mu)) and ``inference``
    (RMDN's (mu, sigma)) with mixed lengths; a training forward with
    dropout 0 gives the same."""
    module, jm, variables = twins(PLAIN[case])
    x = inputs()
    xt, lengths = torch.from_numpy(x), torch.from_numpy(LENGTHS)
    with torch.no_grad():
        _close(module(xt, lengths), jm.apply(variables, x, LENGTHS))
        _close(module.inference(xt, lengths),
               jm.apply(variables, x, LENGTHS, method=jm.inference))
        _close(module(xt, lengths, train=True,
                      generator=torch.Generator().manual_seed(0)),
               jm.apply(variables, x, LENGTHS))
    want = (PredictionType.PROBABILISTIC if case.startswith("rmdn")
            else PredictionType.DETERMINISTIC)
    assert module.prediction_type().name == jm.prediction_type().name \
        == want.name


def _jax_filter(channels, filt_dim, taps, **kw):
    f = jax_layers.TrTimeInvFIRFilter(channels, filt_dim, **kw)
    return f, {"params": {"taps": jnp.asarray(taps)}}


@pytest.mark.parametrize("causal,tanh,fixed_0th,filt_dim", [
    (True, True, True, 4), (False, True, True, 5), (False, False, False, 4),
    (True, False, True, 1), (True, True, False, 3)])
def test_fir_filter_and_its_inverse_match_jax(causal, tanh, fixed_0th,
                                              filt_dim):
    """The FIR filter at odd T with mixed lengths, causal or shifted by
    (K - 1) // 2, and the IIR inverse against JAX's ``lax.scan``; a causal
    filter's inverse undoes it."""
    kw = dict(causal=causal, tanh=tanh, fixed_0th=fixed_0th)
    f = TrTimeInvFIRFilter(3, filt_dim, **kw)
    init_module(f, seed=filt_dim)
    taps = f.taps.detach().numpy()
    assert 0.5 < taps.std() * filt_dim < 2.0 or taps.size < 6
    jf, variables = _jax_filter(3, filt_dim, taps, **kw)
    x = inputs(3, seed=filt_dim)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        _close(f(xt), jf.apply(variables, x))
        _close(f.coefs(), jf.apply(variables, method=jf.coefs))
        if not causal:
            with pytest.raises(ValueError, match="causal"):
                f.inverse(xt)
            return
        _close(f.inverse(xt), jf.apply(variables, x, method=jf.inverse))
        if fixed_0th:
            _close(f.inverse(f(xt)), x, atol=1e-4)


SAR = {"lstmrnn_sar": lstmrnn_sar(), "conv_sar": conv_sar()}


@pytest.mark.parametrize("case", sorted(SAR))
def test_shallow_ar_models_match_jax(case):
    """Forward, the filtered target (``preprocess_target``) and
    ``inference`` (the forward through the inverse filters)."""
    module, jm, variables = twins(SAR[case])
    x, y = inputs(), inputs(6, seed=3)
    xt, lengths = torch.from_numpy(x), torch.from_numpy(LENGTHS)
    with torch.no_grad():
        _close(module(xt, lengths), jm.apply(variables, x, LENGTHS))
        _close(module.preprocess_target(torch.from_numpy(y)),
               jm.apply(variables, y, method=jm.preprocess_target))
        _close(module.inference(xt, lengths),
               jm.apply(variables, x, LENGTHS, method=jm.inference))


TRANSFORMERS = {
    # (config, T): T = 7 under r = 3 leaves 2 frames, under the window
    "r1": (transformer(), T),
    "r2_conv_embed": (transformer(reduction_factor=2, downsample_by_conv=True,
                                  embed_dim=6, in_ph_start_idx=2,
                                  in_ph_end_idx=7), T),
    "r3_slice_window2": (transformer(reduction_factor=3, window_size=2,
                                     num_heads=1), 7),
    "no_window": (transformer(window_size=None, num_layers=1), T),
}


@pytest.mark.parametrize("case", sorted(TRANSFORMERS))
def test_transformer_encoder_matches_jax(case):
    """At odd T with mixed lengths (the skew trick pads and reshapes), with
    sequences longer and shorter than the relative window, the reduction
    factor by slicing or a depthwise conv, and the phoneme embedding; a
    training forward with dropout 0 gives the same."""
    net, T_in = TRANSFORMERS[case]
    module, jm, variables = twins(net)
    lengths = np.minimum(LENGTHS, T_in)
    lengths[1:] = np.maximum(lengths[1:] - 1, 3)
    x = inputs(seed=4, T=T_in, lengths=lengths)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lengths)
    want = jm.apply(variables, x, lengths)
    r = net.get("reduction_factor", 1)
    assert want.shape == (B, T_in // r * r, 5)
    with torch.no_grad():
        _close(module(xt, lt), want)
        _close(module(xt, lt, train=True,
                      generator=torch.Generator().manual_seed(0)), want)


@pytest.mark.parametrize("L", [1, 2, 5, 8])
def test_relative_position_helpers_match_jax(L):
    """The skew trick both ways and the windowed table, at lengths below,
    at and above the window."""
    from ensemble_svs_with_interactions_tpu.models import generic as jg

    rng = np.random.default_rng(L)
    rel = rng.normal(size=(2, 3, L, 2 * L - 1)).astype(np.float32)
    ab = rng.normal(size=(2, 3, L, L)).astype(np.float32)
    emb = rng.normal(size=(1, 7, 4)).astype(np.float32)
    _close(generic._relative_to_absolute(torch.from_numpy(rel)),
           jg._relative_to_absolute(jnp.asarray(rel)), atol=0)
    _close(generic._absolute_to_relative(torch.from_numpy(ab)),
           jg._absolute_to_relative(jnp.asarray(ab)), atol=0)
    _close(generic._windowed_relative_embeddings(torch.from_numpy(emb), L, 3),
           jg._windowed_relative_embeddings(jnp.asarray(emb), L, 3), atol=0)


RESF0 = {
    "vp": resf0_vp(),
    "vp_mdn_embed": resf0_vp(use_mdn=True, num_gaussians=2, embed_dim=5,
                             in_ph_start_idx=6, in_ph_end_idx=10),
    "transformer": resf0_transformer(),
    "transformer_r2": resf0_transformer(reduction_factor=2),
}


@pytest.mark.parametrize("case", sorted(RESF0))
def test_resf0_models_match_jax(case):
    """(prediction, lf0 residual) and ``inference`` with mixed lengths at
    odd T: the transformer's prediction is truncated to the input's T
    where the reduction factor rounds it down."""
    module, jm, variables = twins(RESF0[case])
    assert module.has_residual_lf0_prediction()
    x = inputs(seed=5)
    xt, lengths = torch.from_numpy(x), torch.from_numpy(LENGTHS)
    with torch.no_grad():
        got = module(xt, lengths)
        _close(got, jm.apply(variables, x, LENGTHS))
        _close(module.inference(xt, lengths),
               jm.apply(variables, x, LENGTHS, method=jm.inference))
    assert module.prediction_type().name == jm.prediction_type().name
    if case == "transformer_r2":
        assert got[0].shape == (B, T - 1, 5)


def test_resf0_transformer_has_no_mdn_head():
    """A config asking the transformer for an MDN head fails to build, in
    both packages."""
    net = resf0_transformer(use_mdn=True)
    with pytest.raises(TypeError):
        instantiate(net)
    with pytest.raises(TypeError):
        jax_instantiate(net)


@pytest.mark.parametrize("layers,stacks,kernel_size", [(3, 1, 3), (4, 2, 2)])
def test_wavenet_matches_jax(layers, stacks, kernel_size):
    """Teacher-forced on the target shifted right by one frame, and
    ``inference`` (a zero target); autoregressive, as in JAX."""
    net = wavenet(layers=layers, stacks=stacks, kernel_size=kernel_size)
    module, jm, variables = twins(net)
    c, y = inputs(seed=6), inputs(4, seed=7)
    ct, yt = torch.from_numpy(c), torch.from_numpy(y)
    with torch.no_grad():
        _close(module(ct, torch.from_numpy(LENGTHS), yt),
               jm.apply(variables, c, LENGTHS, y))
        _close(module.inference(ct), jm.apply(variables, c,
                                              method=jm.inference))
        shifted = module(ct, y=yt)
        yt[:, -1] += 1.0  # the last target frame reaches no output
        assert torch.equal(module(ct, y=yt), shifted)
    assert module.is_autoregressive() and jm.is_autoregressive()


TEMPLATES = {"ffn": ffn(), "lstmrnn": lstmrnn(), "rmdn": rmdn(),
             **SAR,
             **{f"transformer_{k}": v for k, (v, _) in TRANSFORMERS.items()},
             **{f"resf0_{k}": v for k, v in RESF0.items()},
             "wavenet": wavenet()}


@pytest.mark.parametrize("case", sorted(TEMPLATES))
def test_flax_templates_match_jax(case):
    """``init_variables`` gives the JAX ``init``'s tree (every path and
    shape), traced by ``jax.eval_shape``; ``torch_to_flax`` inverts
    ``flax_to_torch`` bitwise."""
    net = TEMPLATES[case]
    module = instantiate(net)
    got = init_variables(module, seed=1)
    jm = jax_instantiate(net)
    args = [jnp.zeros((1, 12, IN)), jnp.array([12])]
    if case == "wavenet":
        args.append(jnp.zeros((1, 12, 4)))
    want = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *args))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(want))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), got) == shapes
    back = torch_to_flax(flax_to_torch(instantiate(net), got))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(got)):
        assert np.array_equal(a, b)


def test_flax_init_draws_the_new_leaves_by_their_schemes():
    """The FIR taps normal(1 / filt_dim), the relative embeddings
    normal(d_k ** -0.5), q/k/v glorot-uniform, ``init_type`` kernels."""
    v = init_variables(instantiate(lstmrnn_sar(
        stream_sizes=[40], ar_orders=[49], out_dim=40)), seed=0)["params"]
    np.testing.assert_allclose(v["filt0"]["taps"].std(), 1 / 50, rtol=0.1)
    v = init_variables(instantiate(transformer(
        hidden_dim=64, num_heads=1, window_size=50)), seed=0)["params"]
    attn = v["_TransformerBlock_0"]["attn"]
    np.testing.assert_allclose(attn["emb_rel_k"].std(), 64 ** -0.5, rtol=0.1)
    q = attn["conv_q"]["kernel"]
    assert np.abs(q).max() <= np.sqrt(6 / 128) and \
        np.abs(q).max() > 0.9 * np.sqrt(6 / 128)
    v = init_variables(instantiate(ffn(hidden_dim=256)), seed=0)["params"]
    np.testing.assert_allclose(v["Dense_1"]["kernel"].var(), 2 / 256,
                               rtol=0.1)


def test_one_target_builds_both_twins():
    """Every class of the zoo resolves from its JAX ``_target_`` (the
    aliases too)."""
    for name in ("FFN", "FeedForwardNet", "LSTMRNN", "LSTMRNNSAR", "RMDN",
                 "Conv1dResnetSAR", "TransformerEncoder"):
        assert instantiate({"_target_": f"{PKG}.{name}", "in_dim": 1,
                            "hidden_dim": 2, "out_dim": 1,
                            **({"attention_dim": 2}
                               if name == "TransformerEncoder" else {})})
    assert generic.FeedForwardNet is generic.FFN


# ------------------------------------------------------------- train steps
def step_batch(net, out_dim, seed=0, T=24):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, T - 5, T - 9], np.int32)
    batch = {"in_feats": inputs(net["in_dim"], seed, T, lengths),
             "out_feats": rng.normal(size=(B, T, out_dim)).astype(
                 np.float32),
             "lengths": lengths}
    if "in_lf0_idx" in net:
        batch["pitch_reg_dyn_ws"] = rng.uniform(
            0, 1, (B, T, 1)).astype(np.float32)
    return batch


STEPS = {
    "ffn": (ffn(), 5, {}),
    "lstmrnn": (lstmrnn(num_layers=1), 5, {}),
    "rmdn": (rmdn(dim_wise=True), 3, {}),
    "lstmrnn_sar": (lstmrnn_sar(), 6, {}),
    "conv_sar": (conv_sar(), 6, {"feats_criterion": "l1"}),
    "transformer": (transformer(reduction_factor=2, downsample_by_conv=True),
                    5, {}),
    "resf0_vp_mdn": (resf0_vp(use_mdn=True, num_gaussians=2), 5,
                     {"pitch_reg_weight": 1.0}),
    "resf0_transformer": (resf0_transformer(), 5, {"pitch_reg_weight": 1.0}),
    "wavenet": (wavenet(), 4, {}),
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_train_step_matches_jax(case):
    """One single-track train step from the port's weights: the evaluation
    before it, the metrics and every gradient; the shallow-AR models score
    their filtered targets (the FIR taps take gradients through them) and
    WaveNet is teacher-forced on the target."""
    net, out_dim, kw = STEPS[case]
    cfg = {"netG": net, "stream_sizes": [out_dim],
           "has_dynamic_features": [False], "num_windows": 1}
    kw = {"pitch_reg_weight": 0.0, **kw}
    variables = torch_to_flax(init_module(instantiate(net), seed=2))
    assert_step_matches_jax(cfg, kw, step_batch(net, out_dim), variables)


def test_shallow_ar_step_filters_the_target_in_the_model_dtype():
    """Under AMP the target is filtered in bf16 (taps cast as the step's
    parameters are), teacher forcing and the loss both see it, and the
    taps take float32 gradients."""
    net = lstmrnn_sar()
    module = init_module(instantiate(net), seed=3)
    batch = step_batch(net, 6, seed=1)
    seen = {}
    filt = module.preprocess_target

    def spy(y):
        seen["dtype"] = y.dtype
        out = filt(y)
        seen["out"] = out.detach().float()
        return out

    module.preprocess_target = spy
    opt, sched = loop.build_optimizer(module.parameters(),
                                      {"name": "SGD", "params": {"lr": 0.0}})
    step, _ = loop.create_train_step(module, opt, {"stream_sizes": [6]},
                                     scheduler=sched, use_amp=True,
                                     device="cpu", pitch_reg_weight=0.0)
    metrics = step(batch, torch.Generator().manual_seed(0))
    assert seen["dtype"] == torch.bfloat16
    with torch.no_grad():
        want = filt(torch.from_numpy(batch["out_feats"]).to(torch.bfloat16))
    assert torch.equal(seen["out"], want.float())
    assert np.isfinite(metrics["Loss"])
    for name, p in module.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
    assert module.filt0.taps.grad[:, 1:].abs().max() > 0
    assert module.filt0.taps.grad[:, 0].abs().max() == 0  # the fixed tap


def test_v3_is_the_multitrack_model_through_a_train_step():
    """``MultiTrackMultistreamSeparateF0ParametricModelv3`` builds the
    base class's weights and takes the same multitrack SGD step as JAX's
    v3 (the tiny flagship's, every dropout 0)."""
    from ensemble_svs_with_interactions_tpu_torch.models.acoustic import (
        MultiTrackMultistreamSeparateF0ParametricModel as Base,
        MultiTrackMultistreamSeparateF0ParametricModelv3 as V3,
    )
    from tests.test_torch_train import SS, _batch, _config, _port_step

    cfg = _config()
    cfg["_target_"] += "v3"
    port = instantiate(cfg)
    assert type(port) is V3 and isinstance(port, Base)
    variables = torch_to_flax(init_module(port, seed=4))
    jm = jax_instantiate(cfg)
    assert type(jm).__name__.endswith("v3")
    opt_cfg = {"name": "SGD", "params": {"lr": 0.5}}
    tx = jax_loop.build_optimizer(opt_cfg)
    jstep, _ = jax_mt.create_multitrack_acoustic_train_step(
        jm, tx, {"stream_sizes": SS}, pitch_reg_weight=1.0, donate=False)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "opt_state": tx.init(variables["params"]),
             "step": jnp.asarray(0)}
    batch = _batch(5)
    new_state, ref = jstep(state, {k: jnp.asarray(v) for k, v in
                                   batch.items()},
                           {"logf0_diff": jnp.asarray(1.0),
                            "mgc_diff": jnp.asarray(1.0)},
                           jax.random.PRNGKey(0))
    module, _, (step, _) = _port_step(cfg, variables, opt_cfg)
    got = step(batch, {"logf0_diff": 1.0, "mgc_diff": 1.0},
               torch.Generator().manual_seed(0))
    for k in ("Loss", "Loss_Feats", "Loss_Pitch", "GradNorm"):
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = flax_to_torch(instantiate(cfg), {
        "params": new_state["params"],
        "batch_stats": new_state["batch_stats"]}).state_dict()
    for k, v in module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=ATOL,
                                   err_msg=k)
