"""The port's diffusion models (``models/diffsinger.py``) against the JAX
package's on the CPU, at tiny widths: the beta schedules and their
float32 tables exactly, ``SinusoidalPosEmb`` and ``DiffNet`` at 1e-5,
each of the four samplers through ``GaussianDiffusion.inference`` with the
JAX chain's noise replayed at 1e-4, the training forward with JAX's t
and noise replayed, and the weights carried both ways.

Every weight is random: the port's modules keep torch's initial weights,
``output_proj`` included (flax starts it at zero, which would make the
denoiser return exactly zero), and ``torch_to_flax`` carries them to the
JAX twin.  The chains' noise cannot match across frameworks by seed, so
``jax_chains`` captures, through ``flax.linen.intercept_methods`` and an
ordered ``jax.debug.callback``, the x_T and the key each JAX sampler
receives, rebuilds the ancestral sampler's per-step draws from that key as
``_p_step`` draws them, and the port replays them through
``diffsinger.chain_noise``.
"""

import contextlib
import functools

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
from ensemble_svs_with_interactions_tpu_torch.models import diffsinger
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

PKG = "ensemble_svs_with_interactions_tpu.models"
ATOL_NET = 1e-5
ATOL_CHAIN = 1e-4
IN = 12
B, T = 2, 24


def diffnet_config(out_dim, channels, layers, enc_dim, cycle=4):
    return {"_target_": f"{PKG}.diffsinger.DiffNet", "in_dim": out_dim,
            "encoder_hidden_dim": enc_dim, "residual_layers": layers,
            "residual_channels": channels, "dilation_cycle_length": cycle}


def encoder_config(in_dim, out_dim, embed_dim=None, dropout=0.0):
    cfg = {"_target_": f"{PKG}.FFConvLSTM", "in_dim": in_dim,
           "ff_hidden_dim": 8, "conv_hidden_dim": 8, "lstm_hidden_dim": 4,
           "num_lstm_layers": 2, "bidirectional": True, "dropout": dropout,
           "out_dim": out_dim}
    if embed_dim is not None:
        cfg.update(in_ph_start_idx=3, in_ph_end_idx=10, embed_dim=embed_dim)
    return cfg


def diffusion_config(out_dim=5, channels=8, layers=3, K=6, enc_dim=6,
                     **kw):
    return {"_target_": f"{PKG}.diffsinger.GaussianDiffusion",
            "in_dim": IN, "out_dim": out_dim, "K_step": K,
            "schedule_type": "linear",
            "encoder": encoder_config(IN, enc_dim),
            "denoise_fn": diffnet_config(out_dim, channels, layers, enc_dim),
            **kw}


def twins(cfg, seed=0):
    """(port module, JAX module, flax variables): the port's torch initial
    weights (seeded), carried to flax."""
    torch.manual_seed(seed)
    module = instantiate(cfg).eval()
    return module, jax_instantiate(cfg), torch_to_flax(module)


def randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


_SAMPLERS = ("_ancestral_sample", "_ddim_sample", "_dpmpp_sample",
             "_plms_sample")
# the capture lists of the open jax_chains blocks: a program traced in one
# block fires its callbacks into the block open when it runs
_CAPTURES = []


def _captured(name, K, x, rng):
    if _CAPTURES:
        _CAPTURES[-1].append((name, K, np.asarray(x), np.asarray(rng)))


@contextlib.contextmanager
def jax_chains():
    """Within the block, every JAX ``GaussianDiffusion`` sampler call's
    noise, as ``diffsinger.chain_noise`` entries in call order (filled in
    when the block ends): x_T as the sampler receives it and, for the
    ancestral sampler, step i's draw ``normal(split(rng, K_step)[i])``.
    The capture is traced into the JAX program, so a jitted call must be
    traced inside such a block."""
    def interceptor(next_fun, args, kwargs, context):
        name = context.method_name
        if (isinstance(context.module, jdiff.GaussianDiffusion)
                and name in _SAMPLERS):
            x = args[0]
            rng = args[2] if name == "_ancestral_sample" else jnp.zeros(
                (2,), jnp.uint32)
            if jnp.issubdtype(rng.dtype, jax.dtypes.prng_key):
                rng = jax.random.key_data(rng)
            jax.debug.callback(functools.partial(
                _captured, name, context.module.K_step), x, rng,
                ordered=True)
        return next_fun(*args, **kwargs)

    raw, draws = [], []
    _CAPTURES.append(raw)
    try:
        with fnn.intercept_methods(interceptor):
            yield draws
        jax.effects_barrier()
    finally:
        _CAPTURES.pop()
    for name, K, x, rng in raw:
        steps = None
        if name == "_ancestral_sample":
            keys = jax.random.split(jnp.asarray(rng), K)
            steps = np.stack([np.asarray(jax.random.normal(k, x.shape,
                                                           x.dtype))
                              for k in keys])
        draws.append({"x_T": x, "steps": steps})


def jax_inference(jmod, v, *args, key=3, **kw):
    """A JAX module's ``inference`` and its chains' noise.  Not jitted:
    the JAX DDIM and DPM++ samplers read their tables with ``np.asarray``,
    which a jit trace refuses."""
    with jax_chains() as draws:
        out = jmod.apply(v, *args, method="inference", **kw,
                         rngs={"diffusion": jax.random.PRNGKey(key),
                               "prenet": jax.random.PRNGKey(key + 1)})
        out = jax.tree_util.tree_map(np.asarray, out)
    return out, draws


@pytest.mark.parametrize("case", [
    {},
    {"scheduler_params": {"max_beta": 0.02, "min_beta": 1e-3}},
    {"schedule_type": "cosine"},
    {"betas": list(np.linspace(1e-4, 0.05, 9))},
], ids=["linear", "linear_params", "cosine", "betas_longer_than_K"])
def test_schedule_tables_match_jax(case):
    """The betas and every float32 table the samplers read equal the JAX
    package's bitwise (float64 NumPy, then cast)."""
    cfg = diffusion_config(K=6, **case)
    module, jmod, v = twins(cfg)
    bound = jmod.bind(v)
    names = {"betas": "_betas", "ac": "_ac", "sqrt_ac": "_sqrt_ac",
             "sqrt_1mac": "_sqrt_1mac", "sqrt_recip_ac": "_sqrt_recip_ac",
             "sqrt_recipm1_ac": "_sqrt_recipm1_ac",
             "post_log_var": "_post_log_var", "post_c1": "_post_c1",
             "post_c2": "_post_c2"}
    assert set(module.tables) == set(names)
    for k, jk in names.items():
        np.testing.assert_array_equal(module.tables[k],
                                      np.asarray(getattr(bound, jk)), k)
    np.testing.assert_array_equal(diffsinger.linear_beta_schedule(7),
                                  jdiff.linear_beta_schedule(7))
    np.testing.assert_array_equal(diffsinger.cosine_beta_schedule(7),
                                  jdiff.cosine_beta_schedule(7))


@pytest.mark.parametrize("dim", [8, 256])
def test_sinusoidal_pos_emb_matches_jax(dim):
    t = np.asarray([0, 1, 7, 99], np.int32)
    ref = jdiff.SinusoidalPosEmb(dim).apply({}, jnp.asarray(t))
    got = diffsinger.sinusoidal_pos_emb(torch.from_numpy(t).long(), dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_NET)


@pytest.mark.parametrize("layers,cycle", [(3, 4), (6, 2)])
def test_diffnet_matches_jax(layers, cycle):
    """``DiffNet`` in the JAX layout (and its channel-first ``denoise``),
    dilations up to 8, with a random ``output_proj``."""
    cfg = diffnet_config(5, 8, layers, 6, cycle)
    net, jnet, v = twins(cfg)
    assert np.abs(v["params"]["output_proj"]["kernel"]).max() > 0
    spec, cond = randn(B, T, 5, seed=1), randn(B, T, 6, seed=2)
    step = np.asarray([0, 5], np.int32)
    ref = np.asarray(jnet.apply(v, jnp.asarray(spec), jnp.asarray(step),
                                jnp.asarray(cond)))
    with torch.no_grad():
        got = net(torch.from_numpy(spec), torch.from_numpy(step).long(),
                  torch.from_numpy(cond)).numpy()
    assert got.shape == ref.shape == (B, T, 5) and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, atol=ATOL_NET)


@pytest.mark.parametrize("case", [
    {"sampler": "ancestral"},
    {"sampler": "ddim", "sampling_steps": 4},
    {"sampler": "dpmpp", "sampling_steps": 4},
    {"sampler": "dpmpp", "sampling_steps": 1},
    {"pndm_speedup": 2},
    {"sampler": "plms", "pndm_speedup": 1},
    {"pndm_speedup": 12},
    {"sampler": "ancestral", "K": 100},
], ids=["ancestral", "ddim", "dpmpp", "dpmpp_one_step", "plms",
        "plms_every_step", "plms_past_K_step", "ancestral_K100"])
def test_sampler_matches_jax(case):
    """``inference`` (encoder, sampler, norm_scale) on the same condition
    and the JAX chain's noise, with speaker embeddings added to the
    encoder's input, over mixed lengths."""
    case = dict(case)
    K = case.pop("K", 10)
    cfg = diffusion_config(K=K, **case)
    cfg["encoder"] = encoder_config(IN, 6, embed_dim=8)
    module, jmod, v = twins(cfg)
    cond, spk = randn(B, T, IN, seed=3), randn(B, T, 8, seed=4) * 0.1
    lengths = np.asarray([T, T - 5])
    ref, draws = jax_inference(jmod, v, jnp.asarray(cond),
                               jnp.asarray(lengths), spk_embs=jnp.asarray(spk))
    assert len(draws) == 1
    with diffsinger.chain_noise(draws):
        got = module.inference(torch.from_numpy(cond),
                               torch.from_numpy(lengths),
                               spk_embs=torch.from_numpy(spk)).numpy()
    assert got.shape == ref.shape == (B, T, 5)
    assert np.isfinite(got).all() and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=ATOL_CHAIN)


def test_ancestral_chain_draws_from_its_generator():
    """Without a replay block the chain draws x_T and one draw a step from
    ``chain_generator``, in that order (a recording block sees the same
    draws), and a generator seeded alike gives the same samples."""
    module, _, _ = twins(diffusion_config(K=4))
    cond = torch.from_numpy(randn(1, T, IN, seed=5))
    out = [module.inference(cond, chain_generator=torch.Generator()
                            .manual_seed(7)) for _ in range(2)]
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
    with diffsinger.chain_noise() as recorded:
        again = module.inference(
            cond, chain_generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(again, out[0], rtol=0, atol=0)
    g = torch.Generator().manual_seed(7)
    x_T = torch.randn((1, T, 5), generator=g)
    steps = torch.stack([torch.randn((1, T, 5), generator=g)
                         for _ in range(4)])
    (entry,) = recorded
    torch.testing.assert_close(entry["x_T"], x_T, rtol=0, atol=0)
    torch.testing.assert_close(entry["steps"], steps, rtol=0, atol=0)
    with diffsinger.chain_noise(recorded):
        replayed = module.inference(cond)
    torch.testing.assert_close(replayed, out[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="chain_generator"):
        module.inference(cond)


@pytest.mark.parametrize("train", [False, True])
def test_training_forward_matches_jax(train):
    """``forward(cond, lengths, y)``: (noise, x_recon) with JAX's t and
    noise replayed (t captured at the denoiser's call, the noise JAX
    returns); in training the encoder's batch norms use the batch's
    statistics on both sides."""
    cfg = diffusion_config(K=10)
    module, jmod, v = twins(cfg)
    cond, y = randn(B, T, IN, seed=6), randn(B, T, 5, seed=7) * 3
    lengths = np.asarray([T, T - 3])
    ts = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, jdiff.DiffNet):
            ts.append(np.asarray(args[1]))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        out = jmod.apply(v, jnp.asarray(cond), jnp.asarray(lengths),
                         jnp.asarray(y), train=train,
                         rngs={"diffusion": jax.random.PRNGKey(11)},
                         mutable=["batch_stats"] if train else False)
    noise, x_recon = out[0] if train else out
    (t,) = ts
    with diffsinger.chain_noise([{"t": t, "noise": np.asarray(noise)}]):
        got_noise, got = module(torch.from_numpy(cond),
                                torch.from_numpy(lengths),
                                torch.from_numpy(y), train=train)
    np.testing.assert_array_equal(got_noise.numpy(), np.asarray(noise))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(x_recon),
                               atol=ATOL_NET)


def test_weights_round_trip():
    """A JAX ``GaussianDiffusion`` (encoder and ``DiffNet``, dilated
    convs included) initialised by flax loads into the port and comes
    back bitwise; a missing or a surplus leaf raises."""
    cfg = diffusion_config(K=4, layers=5)
    jmod = jax_instantiate(cfg)
    v = jax.jit(lambda s: jmod.init(
        {"params": jax.random.PRNGKey(s), "diffusion": jax.random.PRNGKey(1)},
        jnp.zeros((1, 8, IN)), jnp.asarray([8]), jnp.zeros((1, 8, 5))))(0)
    v = jax.tree_util.tree_map(np.asarray, v)
    port = flax_to_torch(instantiate(cfg), v)
    assert tuple(port.denoise_fn.res3.dilated_conv.weight.shape) == (16, 8, 3)
    assert port.denoise_fn.res3.dilated_conv.dilation == (8,)
    back = torch_to_flax(port)
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(v)]
    for (p, a), (_, b) in zip(flat(back), flat(v)):
        np.testing.assert_array_equal(a, b, str(p))
    params = dict(v["params"])
    params["denoise_fn"] = {k: w for k, w in params["denoise_fn"].items()
                            if k != "res4"}
    with pytest.raises(ValueError, match="res4"):
        flax_to_torch(instantiate(cfg), {**v, "params": params})
    params = dict(v["params"], extra={"kernel": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="extra"):
        flax_to_torch(instantiate(cfg), {**v, "params": params})


@pytest.mark.parametrize("name", ["MultiSpeakerGaussianDiffusion",
                                  "FFTBlocksEncoder", "PitchPredictor",
                                  "PitchExtractor"])
def test_unported_diffsinger_modules_raise(name):
    """A module of ``models/diffsinger.py`` that ``gen.UNPORTED`` names
    raises, naming it; the others build (``tests/test_torch_mel_models.py``
    holds them against JAX)."""
    from ensemble_svs_with_interactions_tpu_torch import gen

    node = {"_target_": f"{PKG}.diffsinger.{name}", "in_dim": 4}
    if name not in gen.UNPORTED:
        if name == "MultiSpeakerGaussianDiffusion":
            # the fields it has no default for, in both packages
            node.update(out_dim=2, denoise_fn={
                "_target_": f"{PKG}.diffsinger.DiffNet", "in_dim": 2,
                "encoder_hidden_dim": 4})
        assert type(instantiate(node)).__name__ == name
        return
    with pytest.raises(NotImplementedError,
                       match=f"models/diffsinger.py \\({name}\\)"):
        instantiate(node)
