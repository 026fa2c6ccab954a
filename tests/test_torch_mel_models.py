"""The mel voices' models on the port against the JAX package's, on the
CPU, at tiny widths, the weights carried by ``utils/flax_port`` from the
port's seeded initial ones: the two mel cascades
(``models/acoustic/multistream.py``), ``MelF0MultistreamPostFilter``,
``models/diffsinger.py``'s reversed positional encoding,
``FFTBlocksEncoder`` (odd T, mixed lengths, the reduction factor, every
option), ``PitchPredictor`` and ``PitchExtractor``, and
``models/flow_matching.FlowMatching`` in training and under both solvers,
at ATOL; the weights of each back through ``torch_to_flax`` bitwise, in
the layout flax's own ``init`` gives.

What the frameworks draw cannot match by seed, so it is replayed: the
diffusion and flow-matching draws (``jax.random.normal`` / ``randint`` /
``uniform`` patched to seeded NumPy draws that are functions of the shape,
``same_draws``; the port takes the same arrays through
``diffsinger.chain_noise``), the postfilter's noise (the same normal
draws) and the FFT blocks' dropout masks
(``replayed_dropout``: flax's ``nn.Dropout`` calls intercepted and given
seeded masks in call order, the port's ``models/layers.dropout`` handed
the same masks in the same order).
"""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.models import diffsinger as jdiff
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch import gen
from ensemble_svs_with_interactions_tpu_torch.models import (
    diffsinger,
    layers,
    postfilters,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

PKG = "ensemble_svs_with_interactions_tpu.models"
ATOL = 1e-5
PE_ATOL = 5e-5
IN = 12
B, T = 2, 23
LENGTHS = np.array([T, 16])


# ------------------------------------------------------------ the draws
def _seed(shape, salt):
    return (int(np.prod(shape)) * 7919 + len(shape) * 31 + salt) % 2 ** 31


def draw_ints(shape, lo, hi):
    return np.random.default_rng(_seed(shape, 1)).integers(
        int(lo), int(hi), tuple(shape)).astype(np.int32)


def draw_normal(shape):
    return np.random.default_rng(_seed(shape, 0)).standard_normal(
        tuple(int(n) for n in shape)).astype(np.float32)


def draw_uniform(shape):
    return np.random.default_rng(_seed(shape, 2)).uniform(
        size=tuple(shape)).astype(np.float32)


@pytest.fixture
def same_draws(monkeypatch):
    """``jax.random.normal`` / ``randint`` / ``uniform`` give seeded NumPy
    draws that are functions of the shape; the port's postfilter noise and
    sampling chains (``diffsinger._normal``) the same normal draws."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(draw_normal(shape), dtype))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, minval, maxval,
                        dtype=jnp.int32: jnp.asarray(
                            draw_ints(shape, minval, maxval), dtype))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=jnp.float32, minval=0.0,
                        maxval=1.0: jnp.asarray(draw_uniform(shape), dtype))
    monkeypatch.setattr(postfilters, "draw_noise",
                        lambda shape, generator: torch.from_numpy(
                            draw_normal(shape)))
    monkeypatch.setattr(diffsinger, "_normal",
                        lambda shape, generator, device: torch.from_numpy(
                            draw_normal(shape)).to(device))


def training_draws(shape, K=None):
    """The ``chain_noise`` training entry of one diffusion (``K``: its
    K_step) or flow-matching forward of targets ``shape`` under
    ``same_draws``."""
    t = draw_ints(shape[:1], 0, K) if K else draw_uniform(shape[:1])
    return {"t": t, "noise": draw_normal(shape)}


@contextlib.contextmanager
def replayed_dropout(monkeypatch):
    """Within the block, flax's ``nn.Dropout`` in training (rate > 0)
    keeps the units of a seeded mask, the k-th call the k-th mask, and the
    port's ``layers.dropout`` replays the recorded masks in order,
    cyclically (a step compared in float32 and float64 runs twice)."""
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, fnn.Dropout) and context.method_name ==
                "__call__" and mod.rate > 0 and not mod.deterministic):
            x = args[0]
            keep = np.random.default_rng(len(masks)).uniform(
                size=x.shape) < 1.0 - mod.rate
            masks.append(keep)
            return jnp.where(keep, x / (1.0 - mod.rate), 0.0)
        return next_fun(*args, **kwargs)

    used = [0]

    def replay(x, p, generator):
        if p <= 0.0:
            return x
        keep = masks[used[0] % len(masks)]
        used[0] += 1
        assert keep.shape == tuple(x.shape), (keep.shape, x.shape)
        keep = torch.from_numpy(keep).to(x.device)
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))

    monkeypatch.setattr(layers, "dropout", replay)
    with fnn.intercept_methods(interceptor):
        yield masks


# ------------------------------------------------------------ helpers
def twins(cfg, seed=0):
    """(port module, JAX module, flax variables): the port's seeded initial
    weights, carried to flax."""
    torch.manual_seed(seed)
    module = instantiate(cfg).eval()
    return module, jax_instantiate(cfg), torch_to_flax(module)


def randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(got, ref, atol=ATOL):
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            close(g, r, atol)
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol)


def diffnet(out_dim, enc_dim, layers_=2):
    return {"_target_": f"{PKG}.diffsinger.DiffNet", "in_dim": out_dim,
            "encoder_hidden_dim": enc_dim, "residual_layers": layers_,
            "residual_channels": 8, "dilation_cycle_length": 2}


def fft(in_dim=IN, out_dim=None, **kw):
    return {"_target_": f"{PKG}.diffsinger.FFTBlocksEncoder",
            "in_dim": in_dim, "hidden_dim": 8, "num_layers": 2,
            "num_heads": 2, "kernel_size": 3, "out_dim": out_dim,
            "dropout": 0.0, **kw}


def ffconvlstm(in_dim, out_dim):
    return {"_target_": f"{PKG}.FFConvLSTM", "in_dim": in_dim,
            "ff_hidden_dim": 8, "conv_hidden_dim": 6, "lstm_hidden_dim": 4,
            "num_lstm_layers": 2, "bidirectional": True, "dropout": 0.0,
            "out_dim": out_dim, "in_ph_start_idx": 3, "in_ph_end_idx": 9,
            "embed_dim": 6}


def lf0_decoder(in_dim):
    """The AR residual-F0 decoder, r = 4, as the shipped mel voice, at
    tiny widths and no prenet dropout."""
    return {"_target_": f"{PKG}.acoustic.BiLSTMResF0NonAttentiveDecoder",
            "in_dim": in_dim, "out_dim": 1, "in_ph_start_idx": 3,
            "in_ph_end_idx": 9, "embed_dim": 6, "ff_hidden_dim": 8,
            "conv_hidden_dim": 6, "lstm_hidden_dim": 4, "num_lstm_layers": 2,
            "decoder_layers": 1, "decoder_hidden_dim": 8, "prenet_layers": 0,
            "prenet_hidden_dim": 4, "prenet_dropout": 0.0,
            "scaled_tanh": True, "zoneout": 0.0, "reduction_factor": 4,
            "downsample_by_conv": True, "in_lf0_idx": 10, "out_lf0_idx": 0,
            "in_lf0_min": 4.7, "in_lf0_max": 6.8, "out_lf0_mean": 5.5,
            "out_lf0_scale": 0.3}


M = 6  # tiny mel width


def cascade(kind, mel="diffusion", **kw):
    """``MDNMultistreamSeparateF0MelModel`` (``kind="mdn"``, the shipped
    mel voice's class) or ``MultistreamSeparateF0MelModel`` with an
    FFConvLSTM encoder; the mel decoder a DDPM (K_step 4) or a
    deterministic FFConvLSTM."""
    if kind == "mdn":
        mel_in, vuv_in = IN + 1, IN + 1 + M
    else:
        mel_in = vuv_in = 8 + 2
    mel_model = ({"_target_": f"{PKG}.diffsinger.GaussianDiffusion",
                  "in_dim": mel_in, "out_dim": M, "K_step": 4,
                  "encoder": ffconvlstm(mel_in, 8),
                  "denoise_fn": diffnet(M, 8)}
                 if mel == "diffusion" else ffconvlstm(mel_in, M))
    net = {"in_dim": IN, "out_dim": M + 2, "stream_sizes": [M, 1, 1],
           "reduction_factor": 4, "in_rest_idx": 0, "in_lf0_idx": 10,
           "out_lf0_idx": M, "lf0_model": lf0_decoder(IN),
           "mel_model": mel_model, "vuv_model": ffconvlstm(vuv_in, 1), **kw}
    if kind == "mdn":
        net["_target_"] = f"{PKG}.acoustic.MDNMultistreamSeparateF0MelModel"
    else:
        net["_target_"] = f"{PKG}.acoustic.MultistreamSeparateF0MelModel"
        net["encoder"] = ffconvlstm(IN, 8)
    return net


def _inputs(seed=0, D=IN):
    x = np.random.default_rng(seed).uniform(0, 1, (B, T, D)).astype(
        np.float32)
    return x, torch.from_numpy(x), torch.from_numpy(LENGTHS)


# ------------------------------------------------------------ the cascades
@pytest.mark.parametrize("kind,kw", [
    ("mdn", {}),
    ("separate", {"lf0_teacher_forcing": False}),
], ids=["mdn", "encoder_no_forcing"])
def test_mel_cascade_matches_jax(same_draws, kind, kw):
    """Teacher-forced (``((mel, lf0, vuv), lf0 residual)``: the DDPM's
    (noise, x_recon) pair with the draws replayed; the encoder cascade's
    decoders on the predicted lf0) and free-running (the point estimates
    [mel | lf0 | vuv]; the encoder-less cascade returns them twice, as the
    JAX model)."""
    cfg = cascade(kind, mel="diffusion" if kind == "mdn" else "ff", **kw)
    module, jmod, v = twins(cfg)
    x, xt, lt = _inputs()
    y = randn(B, T, M + 2, seed=1)
    y[..., M + 1] = y[..., M + 1] > 0
    rngs = {"diffusion": jax.random.PRNGKey(0),
            "prenet": jax.random.PRNGKey(1)}
    apply = jax.jit(lambda v, *a: jmod.apply(v, *a, rngs=rngs))
    ref = apply(v, jnp.asarray(x), jnp.asarray(LENGTHS), jnp.asarray(y))
    draws = [training_draws((B, T, M), 4)] if kind == "mdn" else []
    with diffsinger.chain_noise(draws):
        got = module(xt, lt, torch.from_numpy(y))
    close(got[0], ref[0])
    close(got[1], ref[1])
    ref = apply(v, jnp.asarray(x), jnp.asarray(LENGTHS))
    got = module(xt, lt, generator=torch.Generator().manual_seed(0),
                 chain_generator=torch.Generator().manual_seed(0))
    if kind == "mdn":
        close(got[1], ref[1])
    close(got[0], ref[0])
    assert got[0].shape == (B, T, M + 2)
    close(module.inference(xt, lt, torch.Generator().manual_seed(0),
                           torch.Generator().manual_seed(0)), ref[0])


def test_jax_encoder_mel_cascade_cannot_sample_a_diffusion_mel(same_draws):
    """JAX's ``MultistreamSeparateF0MelModel`` runs its mel decoder's
    ``__call__`` free-running (``multistream.py:399``), so a DDPM mel
    decoder divides the absent target (``diffsinger.py:198``) and raises;
    the port samples it through ``inference``, as its NPSS cascades do
    (not copied: ROADMAP Queue 3)."""
    cfg = cascade("separate")
    module, jmod, v = twins(cfg)
    x, xt, lt = _inputs()
    with pytest.raises(TypeError, match="NoneType"):
        jax.eval_shape(lambda: jmod.apply(
            v, jnp.asarray(x), jnp.asarray(LENGTHS),
            rngs={"diffusion": jax.random.PRNGKey(0),
                  "prenet": jax.random.PRNGKey(1)}))
    out = module.inference(xt, lt, torch.Generator(), torch.Generator())
    assert out.shape == (B, T, M + 2) and torch.isfinite(out).all()


# ------------------------------------------------------------ postfilter
@pytest.mark.parametrize("case", [
    {"mel_offset": 0, "lf0": False},
    {"mel_offset": 2, "lf0": True},
], ids=["shipped", "offset_lf0"])
def test_mel_postfilter_matches_jax(same_draws, case):
    """Training and inference (the frame-wise noise smoothed) with the
    same noise; V/UV passes untouched."""
    conv = {"_target_": f"{PKG}.postfilters.Conv2dPostFilter",
            "channels": 4, "kernel_size": [3, 3], "init_type":
            "kaiming_normal", "noise_type": "frame_wise", "noise_scale": 1.0,
            "smoothing_width": 5}
    cfg = {"_target_": f"{PKG}.postfilters.MelF0MultistreamPostFilter",
           "stream_sizes": [M, 1, 1], "mel_postfilter": conv,
           "mel_offset": case["mel_offset"],
           "lf0_postfilter": dict(conv, noise_type="bin_wise")
           if case["lf0"] else None}
    module, jmod, v = twins(cfg)
    x = randn(B, T, M + 2, seed=2)
    xt = torch.from_numpy(x)
    close(module(xt), jmod.apply(v, jnp.asarray(x)))
    got = module.inference(xt)
    close(got, jmod.apply(v, jnp.asarray(x), method="inference"))
    got = got.detach().numpy()
    np.testing.assert_array_equal(got[..., -1], x[..., -1])
    if case["mel_offset"]:
        np.testing.assert_array_equal(got[..., :2], x[..., :2])


# ------------------------------------------------------------ diffsinger
@pytest.mark.parametrize("T_,d", [(7, 6), (5003, 4)])
def test_rel_positional_encoding_matches_jax(T_, d):
    """The reversed table (longer than ``max_len``: the table grows), in
    float32 as JAX computes it.  Its angles run up to 5000 radians, where
    XLA's and torch's float32 sin and cos part by up to 3e-5 (the
    products they reduce are equal), hence PE_ATOL."""
    close(diffsinger.rel_positional_encoding(T_, d),
          jdiff._rel_positional_encoding(T_, d), atol=PE_ATOL)


FFT_CASES = {
    "hidden": {},
    "out": {"out_dim": 5},
    "reduced_conv_embed": {"out_dim": 5, "reduction_factor": 4,
                           "ffn_kernel_size": 5, "embed_dim": 6,
                           "in_ph_start_idx": 3, "in_ph_end_idx": 9,
                           "use_pos_embed_alpha": False},
    "reduced_skip": {"out_dim": 3, "reduction_factor": 3,
                     "downsample_by_conv": False, "use_last_norm": False},
    "no_pos": {"use_pos_embed": False, "num_heads": 4},
}


@pytest.mark.parametrize("case", sorted(FFT_CASES))
def test_fft_encoder_matches_jax(case):
    """Odd T, mixed lengths (padded keys masked, padded frames zero), in
    evaluation; ``pos_embed_alpha`` off one so it counts.  (Training,
    with every dropout replayed, is held by the flow-matching forward
    here and by ``tests/test_torch_mel_voice.py``'s train steps.)"""
    cfg = fft(**FFT_CASES[case])
    module, jmod, v = twins(cfg)
    if module.pos_embed_alpha is not None:
        with torch.no_grad():
            module.pos_embed_alpha.fill_(0.7)
        v = torch_to_flax(module)
    x, xt, lt = _inputs(3)
    ref = jax.jit(jmod.apply)(v, jnp.asarray(x), jnp.asarray(LENGTHS))
    close(module(xt, lt), ref)


@pytest.mark.parametrize("cls,kw", [
    ("PitchPredictor", {"in_dim": 7, "hidden_dim": 8, "num_layers": 2,
                        "kernel_size": 3}),
    ("PitchExtractor", {"in_dim": 7, "hidden_dim": 8, "prenet_layers": 2,
                        "conv_layers": 2, "predictor_layers": 2,
                        "kernel_size": 4}),
])
def test_pitch_models_match_jax(cls, kw):
    """(lf0, V/UV logit) and ``inference``: [lf0 | sigmoid(V/UV)] of the
    predictor, the extractor's natural-log lf0 zeroed where V/UV > 0."""
    cfg = {"_target_": f"{PKG}.diffsinger.{cls}", **kw}
    module, jmod, v = twins(cfg)
    x = randn(B, T, 7, seed=6)
    close(module(torch.from_numpy(x)), jmod.apply(v, jnp.asarray(x)))
    got = module.inference(torch.from_numpy(x))
    close(got, jmod.apply(v, jnp.asarray(x), method="inference"))
    if cls == "PitchExtractor":
        assert (got == 0).any() and (got != 0).any()


# ------------------------------------------------------------ flow matching
def flow(solver="midpoint"):
    return {"_target_": f"{PKG}.flow_matching.FlowMatching", "in_dim": IN,
            "out_dim": M, "norm_scale": 10, "sampling_steps": 2,
            "solver": solver, "encoder": fft(), "denoise_fn": diffnet(M, 8)}


@pytest.mark.parametrize("solver", ["euler", "midpoint"])
def test_flow_matching_samples_as_jax(same_draws, solver):
    """``inference`` from the same x at t = 0."""
    module, jmod, v = twins(flow(solver))
    x, xt, lt = _inputs(7)
    ref = jmod.apply(v, jnp.asarray(x), jnp.asarray(LENGTHS),
                     method="inference",
                     rngs={"diffusion": jax.random.PRNGKey(0)})
    with diffsinger.chain_noise([{"x_T": draw_normal((B, T, M)),
                                  "steps": None}]):
        got = module.inference(xt, lt)
    close(got, ref, atol=1e-4)
    assert float(np.abs(np.asarray(ref)).max()) > 1.0


def test_flow_matching_trains_as_jax(same_draws, monkeypatch):
    """The training forward: (x1 - x0, the predicted velocity) with JAX's
    t and x0, in evaluation and in training (the FFT blocks' attention
    and FFN dropouts, 0.1 whatever the config says, replayed)."""
    module, jmod, v = twins(flow())
    x, xt, lt = _inputs(8)
    y = randn(B, T, M, seed=9) * 3
    for train in (False, True):
        with replayed_dropout(monkeypatch) as masks:
            ref = jmod.apply(v, jnp.asarray(x), jnp.asarray(LENGTHS),
                             jnp.asarray(y), train=train,
                             rngs={"diffusion": jax.random.PRNGKey(0),
                                   "dropout": jax.random.PRNGKey(1)})
            with diffsinger.chain_noise([training_draws((B, T, M))]):
                got = module(xt, lt, torch.from_numpy(y), train=train,
                             generator=torch.Generator())
        assert len(masks) == (4 if train else 0)
        close(got, ref)
    with pytest.raises(ValueError, match="torch.Generator"):
        module(xt, lt, torch.from_numpy(y))


def test_multi_speaker_flow_matching_raises():
    """Named when the port refused the multi-speaker decoders; now both
    build from their JAX ``_target_`` (``tests/test_torch_multi_speaker.py``
    holds them against JAX) and ``gen.UNPORTED`` names nothing (the vibrato
    streams, the last it named, are ported)."""
    spk = {"_target_": f"{PKG}.SpeakerEmbedding", "num_embeddings": 3,
           "embedding_dim": 4}
    for target in ("flow_matching.MultiSpeakerFlowMatching",
                   "diffsinger.MultiSpeakerGaussianDiffusion"):
        module = instantiate({"_target_": f"{PKG}.{target}", "in_dim": IN,
                              "out_dim": M, "denoise_fn": diffnet(M, IN),
                              "speaker_embedding": spk})
        assert type(module).__name__ == target.split(".")[1]
    assert set(gen.UNPORTED) == set()


# ------------------------------------------------------------ the weights
ROUND_TRIPS = {
    "fft_encoder": (fft(out_dim=5, reduction_factor=2, embed_dim=6,
                        in_ph_start_idx=3, in_ph_end_idx=9), 1),
    "mel_postfilter": ({"_target_":
                        f"{PKG}.postfilters.MelF0MultistreamPostFilter",
                        "stream_sizes": [M, 1, 1],
                        "mel_postfilter": {
                            "_target_": f"{PKG}.postfilters.Conv2dPostFilter",
                            "channels": 2, "kernel_size": [3, 3],
                            "noise_type": "frame_wise"},
                        "lf0_postfilter": None}, M + 2),
    "flow_matching": (flow(), 1),
    "pitch_extractor": ({"_target_": f"{PKG}.diffsinger.PitchExtractor",
                         "in_dim": IN, "hidden_dim": 4, "prenet_layers": 1,
                         "conv_layers": 1, "predictor_layers": 1}, 1),
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIPS))
def test_weights_round_trip(case):
    """Variables in the layout of flax's own ``init`` of the JAX module
    (traced, filled with seeded draws) load into the port and come back
    bitwise, path for path; a missing leaf raises."""
    cfg, _ = ROUND_TRIPS[case]
    jmod = jax_instantiate(cfg)
    shape = (1, 8, M + 2 if "postfilter" in case else IN)
    args = [jnp.zeros(shape), jnp.asarray([8])]
    if case == "flow_matching":
        args.append(jnp.zeros((1, 8, M)))
    template = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
         "diffusion": jax.random.PRNGKey(2)}, *args))
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), template)
    port = flax_to_torch(instantiate(cfg), v)
    back = torch_to_flax(port)
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(v)]
    for (p, a), (_, b) in zip(flat(back), flat(v)):
        np.testing.assert_array_equal(a, b, str(p))
    params = {k: w for k, w in v["params"].items()
              if k != sorted(v["params"])[-1]}
    with pytest.raises(ValueError, match="not consumed|not set"):
        flax_to_torch(instantiate(cfg), {"params": params})
