"""The parts of the port's vocoder training against the JAX package's on
the CPU, at tiny widths: every discriminator's feature maps at 1e-5 (odd
T that no period divides, strided "SAME" convs, grouped scale convs, the
weight-norm formula with non-unit gains), the weights carried both ways
bitwise, ``stft_mag`` and the STFT, mel and source losses, the mel
filterbank and the CheapTrick tables bitwise, the CheapTrick envelope at
1e-4, and each source-filter generator's training tuple and its gradient
at 1e-4.

Inputs come from seeded numpy; the port's modules keep torch's seeded
initial weights (the weight-norm gains drawn away from one) and
``torch_to_flax`` carries them to the JAX twin, which is jitted with its
variables as an argument.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.data.data_source import (
    mel_filterbank as jax_mel_filterbank,
)
from ensemble_svs_with_interactions_tpu.models.vocoders import (
    cheaptrick as jct,
    discriminators as jdisc,
)
from ensemble_svs_with_interactions_tpu.train import vocoder as jvoc
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.data.data_source import (
    mel_filterbank,
)
from ensemble_svs_with_interactions_tpu_torch.models.vocoders import (
    cheaptrick as ct,
    discriminators as disc,
)
from ensemble_svs_with_interactions_tpu_torch.train import vocoder as voc
from ensemble_svs_with_interactions_tpu_torch.train.loop import _moment_tree
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from tests.test_torch_vocoders import GENERATORS, inputs

VOC = "ensemble_svs_with_interactions_tpu.models.vocoders"
T_ODD = 331          # no period of (2, 3, 5) divides it
_SPEC = {"fft_sizes": [64, 128], "hop_sizes": [16, 32],
         "win_lengths": [32, 64]}
_PERIOD = {"channels": 4, "max_downsample_channels": 16,
           "downsample_scales": [3, 3, 1]}
_SCALE = {"channels": 8, "max_downsample_channels": 32, "max_groups": 4,
          "kernel_sizes": [5, 7, 3, 3], "downsample_scales": [2, 4, 1]}
DISCRIMINATORS = {
    "pwg": {"_target_": f"{VOC}.PWGDiscriminator", "layers": 4,
            "conv_channels": 6},
    "pwg_exp_dilation": {"_target_": f"{VOC}.PWGDiscriminator",
                         "layers": 4, "conv_channels": 6,
                         "dilation_factor": 2, "kernel_size": 5},
    "pwg_plain": {"_target_": f"{VOC}.PWGDiscriminator", "layers": 3,
                  "conv_channels": 4, "use_weight_norm": False,
                  "nonlinear_activation_params": {"negative_slope": 0.3}},
    "period": {"_target_": f"{VOC}.HiFiGANPeriodDiscriminator", "period": 5,
               **_PERIOD},
    "mpd": {"_target_": f"{VOC}.HiFiGANMultiPeriodDiscriminator",
            "periods": [2, 3, 5], "discriminator_params": _PERIOD},
    "scale_ungrouped": {"_target_": f"{VOC}.HiFiGANScaleDiscriminator",
                        **_SCALE, "channels": 6},
    "msd": {"_target_": f"{VOC}.HiFiGANMultiScaleDiscriminator",
            "scales": 2, "discriminator_params": _SCALE},
    "msmpd": {"_target_": f"{VOC}.HiFiGANMultiScaleMultiPeriodDiscriminator",
              "scales": 2, "periods": [2, 3],
              "scale_discriminator_params": _SCALE,
              "scale_downsample_pooling_params": {"kernel_size": 4,
                                                  "stride": 2,
                                                  "padding": 2},
              "period_discriminator_params": _PERIOD},
    "mrsd": {"_target_": f"{VOC}.UnivNetMultiResolutionSpectralDiscriminator",
             **_SPEC, "discriminator_params": {"channels": 4}},
    "mrmpd": {"_target_":
              f"{VOC}.UnivNetMultiResolutionMultiPeriodDiscriminator",
              **_SPEC, "periods": [2, 3],
              "spectral_discriminator_params": {"channels": 4},
              "period_discriminator_params": _PERIOD},
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Tiny tensors gain nothing from torch's threads, and the suite's
    other workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def disc_twins(cfg, seed=0):
    """The port's discriminator (seeded weights, weight-norm gains drawn
    from [0.5, 1.5]), its JAX twin and the twin's variables."""
    torch.manual_seed(seed)
    module = instantiate(cfg)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, disc.SameConv) and m.scale is not None:
                m.scale.uniform_(0.5, 1.5)
    return module, jax_instantiate(cfg), torch_to_flax(module)


def _maps(outs):
    """The port's feature maps as a flat list in the JAX layouts
    (channels last)."""
    return [np.moveaxis(f.detach().numpy(), 1, -1)
            for maps in voc._flatten_d_outs(outs) for f in maps]


@pytest.mark.parametrize("name", sorted(DISCRIMINATORS))
def test_discriminator_matches_jax(name):
    module, jmod, variables = disc_twins(DISCRIMINATORS[name])
    x = randn(2, T_ODD, 1, scale=0.3)
    ref = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    got = module(torch.from_numpy(x))
    ref_maps = [np.asarray(f) for maps in jvoc._flatten_d_outs(ref)
                for f in maps]
    got_maps = _maps(got)
    assert len(got_maps) == len(ref_maps)
    for g, r in zip(got_maps, ref_maps):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["mrmpd", "msmpd", "pwg_plain"])
def test_discriminator_weights_round_trip(name):
    """torch -> flax -> torch and JAX's own init -> torch -> flax, each
    bitwise; the flax tree has JAX's paths (``WeightNorm_{k}`` scopes)."""
    cfg = DISCRIMINATORS[name]
    module, jmod, variables = disc_twins(cfg)
    twin = instantiate(cfg)
    flax_to_torch(twin, variables)
    for (n, a), (_, b) in zip(module.state_dict().items(),
                              twin.state_dict().items()):
        assert torch.equal(a, b), n
    jvars = jax.jit(lambda k: jmod.init(k, jnp.zeros((1, T_ODD, 1))))(
        jax.random.PRNGKey(0))
    back = torch_to_flax(flax_to_torch(instantiate(cfg), jvars))
    ref = jax.tree_util.tree_leaves_with_path(jvars)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (p, g), (_, r) in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r), err_msg=str(p))


def test_spectral_norm_is_refused():
    with pytest.raises(NotImplementedError):
        disc.HiFiGANPeriodDiscriminator(use_spectral_norm=True)
    with pytest.raises(NotImplementedError):
        disc.HiFiGANScaleDiscriminator(use_spectral_norm=True)


@pytest.mark.parametrize("T,win,window", [(300, 64, "hann_window"),
                                          (50, 64, "hann_window"),
                                          (257, 48, "hamming")])
def test_stft_mag_matches_jax(T, win, window):
    """Uncentred frames, a symmetric window; T < win clamps indices past
    the end to the last sample, as JAX's gather does."""
    x = randn(2, T, seed=1)
    ref = jdisc._stft_mag(jnp.asarray(x), 128, 16, win, window)
    got = disc.stft_mag(torch.from_numpy(x), 128, 16, win, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_mel_filterbank_is_bitwise_jax():
    for args in ((48000, 2048, 80, 0, None), (48000, 4096, 80, 0, None),
                 (16000, 256, 20, 30, 7000)):
        np.testing.assert_array_equal(mel_filterbank(*args),
                                      jax_mel_filterbank(*args))


def _loss_pair(fn_port, fn_jax, *arrays):
    """The port's loss and its gradient on the first array against
    JAX's."""
    ts = [torch.from_numpy(a) for a in arrays]
    ts[0].requires_grad_(True)
    out = fn_port(*ts)
    loss = sum(out) if isinstance(out, tuple) else out
    (grad,) = torch.autograd.grad(loss, ts[0])

    def jloss(*a):
        o = fn_jax(*a)
        return sum(o) if isinstance(o, tuple) else o

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        *[jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * scale)


def test_stft_loss_matches_jax():
    """One Frobenius ratio over the whole batch per resolution."""
    res = ((64, 128), (16, 32), (32, 64))
    scales = np.array([[0.1], [1.0], [10.0]], np.float32)
    y_hat, y = randn(3, 700, seed=2), randn(3, 700, seed=3) * scales
    _loss_pair(lambda a, b: voc.stft_loss(a, b, *res),
               lambda a, b: jvoc.stft_loss(a, b, *res), y_hat, y)
    sc, _ = voc.stft_loss(torch.from_numpy(y_hat), torch.from_numpy(y),
                          *res)
    per_item = np.mean([[float(voc.stft_loss(
        torch.from_numpy(y_hat[i:i + 1]), torch.from_numpy(y[i:i + 1]),
        *res)[0])] for i in range(3)])
    assert abs(float(sc) - per_item) > 0.1


def test_mel_spectral_loss_matches_jax():
    fb = mel_filterbank(16000, 256, 20, 0, None).astype(np.float32)
    y_hat, y = randn(2, 1500, seed=4), randn(2, 1500, seed=5)
    _loss_pair(lambda a, b: voc.mel_spectral_loss(
        a, b, torch.from_numpy(fb), 256, 64, 256),
        lambda a, b: jvoc.mel_spectral_loss(a, b, jnp.asarray(fb), 256, 64,
                                            256), y_hat, y)


SR, HOP, FFT, F0_FLOOR, F0_CEIL = 16000, 64, 1024, 70, 400


def _f0(B, n, seed):
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(60, 450, (B, n)) * (rng.uniform(size=(B, n)) > 0.2)
    f0[:, :2] = [200.5, 201.5]  # two halves, rounded to even
    return f0.astype(np.float32)


def test_cheaptrick_tables_are_bitwise_jax():
    args = (SR, FFT, F0_FLOOR, F0_CEIL)
    np.testing.assert_array_equal(ct._window_table(*args),
                                  jct._window_table(*args))
    for a, b in zip(ct._lifter_tables(*args), jct._lifter_tables(*args)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("power,elim_0th", [(False, False), (True, True)])
def test_cheaptrick_envelope_matches_jax(power, elim_0th):
    layer = ct.CheapTrickLayer(SR, HOP, FFT, F0_FLOOR, F0_CEIL)
    jlayer = jct.CheapTrickLayer(SR, HOP, FFT, F0_FLOOR, F0_CEIL)
    x, f0 = randn(2, 40 * HOP, seed=6), _f0(2, 40, 7)
    ref = jlayer(jnp.asarray(x), jnp.asarray(f0), power, elim_0th)
    got = layer(torch.from_numpy(x), torch.from_numpy(f0), power, elim_0th)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_source_regularization_loss_and_gradient_match_jax():
    layer = ct.CheapTrickLayer(SR, HOP, FFT, F0_FLOOR, F0_CEIL)
    jlayer = jct.CheapTrickLayer(SR, HOP, FFT, F0_FLOOR, F0_CEIL)
    src, f0 = randn(2, 30 * HOP, seed=8, scale=0.1), _f0(2, 30, 9)
    _loss_pair(lambda s, f: ct.source_regularization_loss(layer, s, f),
               lambda s, f: jct.source_regularization_loss(jlayer, s, f),
               src, f0)


@pytest.mark.parametrize("mel", [False, True])
def test_residual_source_loss_matches_jax(mel):
    layer = ct.CheapTrickLayer(SR, HOP, FFT, F0_FLOOR, F0_CEIL)
    jlayer = jct.CheapTrickLayer(SR, HOP, FFT, F0_FLOOR, F0_CEIL)
    fb = (mel_filterbank(SR, FFT, 20, 0, None).astype(np.float32) if mel
          else None)
    src, y = randn(2, 48 * HOP, seed=10), randn(2, 48 * HOP, seed=11)
    f0 = _f0(2, 48, 12)
    _loss_pair(
        lambda s, yy, f: voc.residual_source_loss(
            layer, s, yy, f, None if fb is None else torch.from_numpy(fb)),
        lambda s, yy, f: jvoc.residual_source_loss(
            jlayer, s, yy, f, None if fb is None else jnp.asarray(fb)),
        src, y, f0)


def test_residual_source_loss_frames_are_half_an_fft_apart():
    """The JAX package's residual subtracts envelope frame n (centred on
    sample n * hop) from STFT frame n (which starts there), and the STFT's
    shorter framing sets the count; the port copies this.  With the
    envelope moved fft / 2 samples later the loss is another number."""
    layer = ct.CheapTrickLayer(SR, HOP, FFT, F0_FLOOR, F0_CEIL)
    src, y = randn(1, 48 * HOP, seed=13), randn(1, 48 * HOP, seed=14)
    f0 = np.full((1, 48), 220.0, np.float32)
    s, yy, f = (torch.from_numpy(a) for a in (src, y, f0))
    shipped = float(voc.residual_source_loss(layer, s, yy, f))
    env = layer(yy, f, elim_0th=True)
    mag = [torch.log(torch.clamp(disc.stft_mag(a, FFT, HOP, FFT), min=1e-7))
           for a in (s, yy)]
    n = mag[0].shape[1]
    assert n == (48 * HOP - FFT) // HOP + 1 < env.shape[1]
    for shift, expect_equal in ((0, True), (FFT // 2 // HOP, False)):
        resid = mag[1] - env[:, shift:shift + n]
        loss = float(torch.mean((mag[0] - resid) ** 2))
        assert (abs(loss - shipped) < 1e-6 * shipped) == expect_equal


TRAIN_GENERATORS = ["usfgan", "parallel_hn", "cascade_hn", "sifigan"]


def _flax_grads(module, grads):
    names = [n for n, _ in module.named_parameters()]
    return _moment_tree(module, names, grads)


@pytest.mark.parametrize("name", TRAIN_GENERATORS)
def test_generator_train_outputs_and_gradient_match_jax(name):
    """``train_outputs`` against JAX's ``__call__`` tuple at 1e-4, and the
    gradient of a loss over the waveform and the source (the hn-uSFGAN's
    debug heads and gates too) against JAX's, leaf by leaf at 1e-4 of the
    largest."""
    cfg, S = GENERATORS[name]
    torch.manual_seed(0)
    module = instantiate(cfg)
    jmod = jax_instantiate(cfg)
    variables = torch_to_flax(module)
    x, c, d = inputs(S, seed=3)
    hn = "hn" in name
    kw = {"debug": True} if hn else {}
    w = [randn(*s, seed=20 + i) for i, s in enumerate(
        [(2, x.shape[1], 1)] * 4 + [(2, x.shape[1], 4)])]

    def weigh(outs, ws):
        return sum((o * wi).sum() for o, wi in zip(outs, ws))

    def jloss(params):
        outs = jmod.apply({"params": params}, x, c, d)
        return weigh(outs, w), outs

    (jl, jouts), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    outs = module.train_outputs(*(torch.from_numpy(a) for a in (x, c, d)),
                                **kw)
    assert len(outs) == len(jouts)
    for o, r in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)
    loss = weigh(outs, [torch.from_numpy(wi) for wi in w])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    params = list(module.parameters())
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        params, torch.autograd.grad(loss, params, allow_unused=True))]
    got = jax.tree_util.tree_leaves_with_path(_flax_grads(module, grads))
    ref = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [p for p, _ in got] == [p for p, _ in ref]
    scale = max(np.abs(np.asarray(r)).max() for _, r in ref)
    for (p, g), (_, r) in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(p))
    # the serving forward (in place for the hn pair) gives the waveform
    with torch.no_grad():
        np.testing.assert_allclose(
            module(*(torch.from_numpy(a) for a in (x, c, d))).numpy(),
            outs[0].detach().numpy(), rtol=1e-5, atol=1e-6)


def test_generator_input_arity_reads_forward():
    for name, n in (("parallel_hn", 3), ("sifigan", 3), ("pwg", 2),
                    ("hifigan", 1)):
        assert voc.generator_input_arity(
            instantiate(GENERATORS[name][0])) == n
