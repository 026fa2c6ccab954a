"""The port's neural vocoders (``models/vocoders/``) against the JAX
package's on the CPU, at tiny widths: the host helpers bitwise
(``dilated_factor``, ``SignalGenerator``), the pitch-dependent taps
exactly, each generator at 1e-4 (uSFGAN, both hn-uSFGAN variants, PWG on
JAX's noise replayed through ``forward``, SiFiGAN, HiFiGAN), the
aperiodicity coder at 1e-6 and its float64 decode, and the weights
carried both ways bitwise.

Every weight is random: the port's modules keep torch's initial weights
(seeded) and ``torch_to_flax`` carries them to the JAX twin.  The JAX
twins are jitted, their variables (or the init's seed) an argument.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.models.vocoders import usfgan as jvoc
from ensemble_svs_with_interactions_tpu.ops.world import codec as jcodec
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.models.vocoders import (
    SignalGenerator,
    dilated_factor,
    usfgan,
)
from ensemble_svs_with_interactions_tpu_torch.ops.world import codec
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

VOC = "ensemble_svs_with_interactions_tpu.models.vocoders"
ATOL = 1e-4
B, TF, AUX = 2, 8, 5
SCALES = [2, 3]
UP = 6


def _net(blockA=0, cycleA=0, blockF=0, cycleF=0, cascade_mode=0):
    return {"blockA": blockA, "cycleA": cycleA, "blockF": blockF,
            "cycleF": cycleF, "cascade_mode": cascade_mode}


_WIDTHS = {"residual_channels": 4, "gate_channels": 8, "skip_channels": 4,
           "aux_channels": AUX, "aux_context_window": 2,
           "upsample_params": {"upsample_scales": SCALES}}
_HN = {"harmonic_network_params": _net(blockA=4, cycleA=2),
       "noise_network_params": _net(blockF=2, cycleF=2),
       "filter_network_params": _net(blockF=4, cycleF=2),
       "periodicity_estimator_params": {"conv_layers": 2, "kernel_size": 3,
                                        "dilation": 1}, **_WIDTHS}
# name -> (config, excitation channels; None: the generator takes c alone)
GENERATORS = {
    "usfgan": ({"_target_": f"{VOC}.USFGANGenerator",
                "source_network_params": _net(blockA=4, cycleA=2),
                "filter_network_params": _net(blockF=4, cycleF=2),
                **_WIDTHS}, 1),
    "usfgan_mixed": ({"_target_": f"{VOC}.USFGANGenerator",
                      "source_network_params": _net(2, 1, 2, 1, 1),
                      "filter_network_params": _net(2, 2, 2, 1, 0),
                      **_WIDTHS}, 1),
    "parallel_hn": ({"_target_": f"{VOC}.ParallelHnUSFGANGenerator", **_HN},
                    2),
    "cascade_hn": ({"_target_": f"{VOC}.CascadeHnUSFGANGenerator", **_HN},
                   2),
    "sifigan": ({"_target_": f"{VOC}.SiFiGANGenerator", "channels": 32,
                 "aux_channels": AUX, "upsample_scales": SCALES,
                 "resblock_kernel_sizes": [3, 5],
                 "resblock_dilations": [[1, 2], [1, 3]]}, 1),
    "pwg": ({"_target_": f"{VOC}.PWGGenerator", "layers": 4, "stacks": 2,
             "residual_channels": 4, "gate_channels": 8, "skip_channels": 4,
             "aux_channels": AUX, "aux_context_window": 2,
             "upsample_scales": SCALES}, None),
    "hifigan": ({"_target_": f"{VOC}.HiFiGANGenerator", "channels": 16,
                 "aux_channels": AUX, "upsample_scales": SCALES,
                 "resblock_kernel_sizes": [3],
                 "resblock_dilations": [[1, 3]]}, None),
}


def randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def inputs(S, seed=0):
    """x (B, T, S), c (B, TF, AUX), d (B, T) float32: d from a random pitch
    contour with unvoiced frames, as ``USFGANWrapper`` builds it."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(60, 900, (B, TF)) * (rng.uniform(size=(B, TF)) > 0.2)
    d = np.stack([np.repeat(dilated_factor(f, 4800, 4), UP) for f in f0])
    return (randn(B, TF * UP, S or 1, seed=seed + 1),
            randn(B, TF, AUX, seed=seed + 2), d.astype(np.float32))


def twins(cfg, seed=0):
    torch.manual_seed(seed)
    module = instantiate(cfg).eval()
    return module, jax_instantiate(cfg), torch_to_flax(module)


def _jax_apply(jmod, method):
    return jax.jit(lambda v, *a: jmod.apply(v, *a, method=method))


def test_dilated_factor_is_bitwise_jax():
    f0 = np.random.default_rng(0).uniform(50, 1000, 300)
    f0[::7] = 0
    for fs, dense in ((48000, 4), (24000, 8)):
        np.testing.assert_array_equal(
            dilated_factor(f0[:, None], fs, dense),
            jvoc.dilated_factor(f0[:, None], fs, dense))


@pytest.mark.parametrize("signal_types", [
    ("sine",), ("sine", "noise"), ("noise",), ("sine", "noise", "uv")])
@pytest.mark.parametrize("noise_amp", [0.003, 0.0])
def test_signal_generator_is_bitwise_jax(signal_types, noise_amp):
    f0 = np.random.default_rng(1).uniform(80, 700, (60, 1))
    f0[10:20] = 0
    args = (48000, 240, 0.1, noise_amp, signal_types)
    for seed in (0, 5):
        got = SignalGenerator(*args)(f0, seed=seed)
        ref = jvoc.SignalGenerator(*args)(f0, seed=seed)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_pd_indexing_is_exact():
    """Taps out of range at both ends read zero; products landing on .5
    round half to even, as ``jnp.rint`` does."""
    T, C = 40, 3
    x = randn(2, T, C, seed=3)
    d = np.random.default_rng(4).uniform(0.2, 30.0, (2, T)).astype(
        np.float32)
    d[0, :8] = [0.5, 1.5, 2.5, 3.5, 0.25, 0.75, 1.25, 4.5]
    d[1, -4:] = [50.0, 0.5, 1.0, 2.5]
    jfn = jax.jit(jvoc.pd_indexing, static_argnums=2)
    for dilation in (1, 2, 4, 8):
        got = usfgan.pd_indexing(torch.from_numpy(x).transpose(1, 2),
                                 torch.from_numpy(d), dilation)
        ref = jfn(jnp.asarray(x), jnp.asarray(d), dilation)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.transpose(1, 2).numpy(),
                                          np.asarray(r))
    past, future = usfgan.pd_indexing(torch.from_numpy(x).transpose(1, 2),
                                      torch.from_numpy(d), 8)
    assert (past[0, :, 0] == 0).all() and (future[1, :, -4] == 0).all()


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_matches_jax(name):
    cfg, S = GENERATORS[name]
    module, jmod, v = twins(cfg, seed=1)
    x, c, d = inputs(S, seed=2)
    with torch.no_grad():
        if name == "pwg":
            # JAX's inference draws normal(PRNGKey(0)); the port replays
            # that noise through forward
            ref = _jax_apply(jmod, "inference")(v, jnp.asarray(c))
            noise = jax.random.normal(jax.random.PRNGKey(0),
                                      (B, TF * UP, 1))
            got = module(torch.from_numpy(np.array(noise)),
                         torch.from_numpy(c))[..., 0]
        elif name == "hifigan":
            ref = _jax_apply(jmod, "inference")(v, jnp.asarray(c))
            got = module.inference(torch.from_numpy(c))
        else:
            ref = _jax_apply(jmod, "inference")(
                v, jnp.asarray(x), jnp.asarray(c), jnp.asarray(d))
            got = module.inference(*(torch.from_numpy(a) for a in (x, c, d)))
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_pwg_inference_draws_seeded_noise():
    cfg, _ = GENERATORS["pwg"]
    module, _, _ = twins(cfg)
    c = torch.from_numpy(randn(TF, AUX))
    with torch.no_grad():
        a, b = module.inference(c), module.inference(c)
        other = module.inference(c, torch.Generator().manual_seed(1))
    assert a.shape == (1, TF * UP)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, other)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_weights_round_trip(name):
    """flax's initial variables load into the port (every leaf consumed,
    every tensor set) and come back bitwise, bias-free convs included."""
    cfg, S = GENERATORS[name]
    jmod = jax_instantiate(cfg)
    x, c, d = (jnp.asarray(a) for a in inputs(S))
    args = (c,) if name == "hifigan" else (
        (x[..., :1], c) if name == "pwg" else (x, c, d))
    v = jax.jit(lambda s: jmod.init(jax.random.PRNGKey(s), *args))(0)
    v = jax.tree_util.tree_map(np.asarray, v)
    port = flax_to_torch(instantiate(cfg), v)
    back = torch_to_flax(port)
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(v)]
    for (p, a), (_, b) in zip(flat(back), flat(v)):
        np.testing.assert_array_equal(a, b, str(p))
    params = dict(v["params"])
    params.pop(sorted(params)[-1])
    with pytest.raises(ValueError, match="not set"):
        flax_to_torch(instantiate(cfg), {"params": params})


@pytest.mark.parametrize("fs", [48000, 44100, 24000])
def test_aperiodicity_codec_matches_jax(fs):
    """``code_aperiodicity`` at 1e-6 of the JAX package's host coder, and
    the float64 decode the neural vocoders' round trip uses at 1e-12."""
    fft = codec.get_cheaptrick_fft_size(fs)
    n = codec.get_num_aperiodicities(fs)
    rng = np.random.default_rng(fs)
    coded = rng.uniform(-60, 0, (50, n))
    ref_ap = np.asarray(jcodec.decode_aperiodicity(coded, fs, fft))
    ap = codec.decode_aperiodicity(torch.from_numpy(coded), fs, fft).numpy()
    assert ap.dtype == np.float64
    np.testing.assert_allclose(ap, ref_ap, rtol=1e-12, atol=0)
    ap = np.clip(ap * rng.uniform(0.5, 1.5, ap.shape), 0.0, 1.0)
    ap[::5, 0] = 1.0
    ap[3, 4:9] = 0.0
    np.testing.assert_allclose(codec.code_aperiodicity(ap, fs),
                               np.asarray(jcodec.code_aperiodicity(ap, fs)),
                               atol=1e-6)
