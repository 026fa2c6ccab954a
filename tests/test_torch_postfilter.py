"""The port's learned postfilters, the merlin postfilter and uncoded WORLD
synthesis against the JAX package, at tiny widths.

Modules: ``Conv2dPostFilter`` (both noise types, with and without the
noise smoother, ``smoothing_width`` <= 5 at this length) and
``MultistreamPostFilter`` (mgc, bap, both, neither) on weights carried by
``flax_to_torch`` and on the same noise, at MODULE_ATOL (float32 convs on
both sides with other summation orders).  The same noise: ``jax.random
.normal`` is patched to return ``_noise(shape)``, seeded NumPy arrays, and
the port gets the same arrays as its ``noise`` argument (or, inside an
engine, through its ``draw_noise``).  For the vocoder's shapes, (N,
samples) and (samples,), the patch returns the port's ``vocoder_noise``,
so the JAX vocoder sees the port's noise.

Engines: one single-track directory with a merged ``MultistreamPostFilter``
(mgc: frame-wise noise smoothed over 100 frames, bap: bin-wise over 5, as
the shipped postfilter configs), written by the JAX package's
``pack_model`` and opened by both ``SPSVS``.  Streams at ATOL, waveforms
at SNR >= 40 dB (the vocoder's bound, tests/test_torch_world.py).
``mc2sp`` at 1e-6 relative; the uncoded WORLD path (``use_world_codec:
false``, and mel-cepstral aperiodicity) through ``gen_world_params`` and
``synthesize`` at ATOL and by SNR.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu import gen as jax_gen
from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
from ensemble_svs_with_interactions_tpu.ops import sptk as jax_sptk
from ensemble_svs_with_interactions_tpu.ops.world import (
    synthesis as jax_syn,
)
from ensemble_svs_with_interactions_tpu.ops.world.codec import (
    get_cheaptrick_fft_size,
)
from ensemble_svs_with_interactions_tpu.svs import SPSVS as JaxSPSVS
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu.utils.packing import pack_model
from ensemble_svs_with_interactions_tpu.utils.scalers import (
    MinMaxScaler as JaxMinMax,
    StandardScaler as JaxStandard,
)
from ensemble_svs_with_interactions_tpu_torch import gen
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.models import postfilters
from ensemble_svs_with_interactions_tpu_torch.ops import sptk
from ensemble_svs_with_interactions_tpu_torch.ops.world import synthesis
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from tests.test_torch_svs import _short_labels, tiny_phases
from tests.test_torch_svs import traced_flax_inits
from tests.test_torch_svs_single import single_track_configs
from tests.util import HED
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

SR = 24000
HOP = SR * 5 // 1000
ATOL = 1e-4
MODULE_ATOL = 1e-5
MC2SP_RTOL = 1e-6
SNR_DB = 40.0
SECONDS = 4.0
PF = "ensemble_svs_with_interactions_tpu.models.postfilters"
STREAMS = [8, 1, 1, 3]


def _noise(shape):
    """Standard normal noise, a function of the shape alone: the
    postfilters' shapes get seeded NumPy draws, the vocoder's the port's
    ``vocoder_noise``."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 1:
        return gen.vocoder_noise(1, shape[0], "cpu").numpy()[0]
    if len(shape) == 2:
        return gen.vocoder_noise(shape[0], shape[1], "cpu").numpy()
    seed = int(np.ravel_multi_index(shape, (64, 4096, 512)) % 2 ** 31)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(autouse=True)
def same_noise(monkeypatch):
    """jax.random.normal and the port's postfilter noise both give
    ``_noise(shape)``."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(_noise(shape), dtype))
    monkeypatch.setattr(postfilters, "draw_noise",
                        lambda shape, generator: torch.from_numpy(
                            _noise(shape)))


def conv_config(channels=4, kernel=(3, 3), noise_type="bin_wise",
                smoothing_width=0, in_dim=None):
    return {"_target_": f"{PF}.Conv2dPostFilter", "channels": channels,
            "kernel_size": list(kernel), "init_type": "kaiming_normal",
            "noise_type": noise_type, "noise_scale": 1.0,
            "smoothing_width": smoothing_width, "in_dim": in_dim}


def multistream_config(mgc=None, bap=None, stream_sizes=STREAMS):
    return {"_target_": f"{PF}.MultistreamPostFilter",
            "stream_sizes": list(stream_sizes), "mgc_postfilter": mgc,
            "bap_postfilter": bap, "lf0_postfilter": None, "mgc_offset": 2,
            "bap_offset": 0}


def _twins(cfg, x):
    """(flax module, its variables as numpy, the port's module carrying
    them)."""
    module = jax_instantiate(cfg)
    variables = jax.tree_util.tree_map(np.asarray, module.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(x)))
    port = instantiate(cfg)
    flax_to_torch(port, variables)
    return module, variables, port


CONV_CASES = {
    "bin_wise": dict(noise_type="bin_wise"),
    "bin_wise_smoothed": dict(noise_type="bin_wise", smoothing_width=5),
    "frame_wise": dict(noise_type="frame_wise", kernel=(5, 3), in_dim=6),
    "frame_wise_smoothed": dict(noise_type="frame_wise", kernel=(5, 3),
                                smoothing_width=4, in_dim=6),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_postfilter_matches_jax(case):
    """Inference (noise smoothed where asked) and the training-mode
    forward (never smoothed) at MODULE_ATOL."""
    kw = CONV_CASES[case]
    B, T, D = 2, 24, 6
    x = np.random.default_rng(0).normal(size=(B, T, D)).astype(np.float32)
    module, variables, port = _twins(conv_config(**kw), x)
    z = torch.from_numpy(_noise(
        (B, T, D if kw["noise_type"] == "bin_wise" else 1)))
    for inference in (True, False):
        ref = np.asarray(module.apply(variables, jnp.asarray(x),
                                      is_inference=inference))
        got = port(torch.from_numpy(x), is_inference=inference,
                   noise=z).detach().numpy()
        np.testing.assert_allclose(got, ref, atol=MODULE_ATOL)
    assert not np.allclose(ref, x)


MULTISTREAM_CASES = {
    "mgc": dict(mgc=conv_config(kernel=(5, 3), noise_type="frame_wise",
                                smoothing_width=5)),
    "bap": dict(bap=conv_config(kernel=(5, 1), smoothing_width=3)),
    "both": dict(mgc=conv_config(kernel=(5, 3), noise_type="frame_wise",
                                 smoothing_width=5),
                 bap=conv_config(kernel=(5, 1), smoothing_width=3)),
    "neither": {},
}


@pytest.mark.parametrize("case", sorted(MULTISTREAM_CASES))
def test_multistream_postfilter_matches_jax(case):
    """Each stream through its own postfilter, mgc dims 0-1 and V/UV
    passed through, at MODULE_ATOL; the port's noise drawn from one
    generator (here ``draw_noise``, patched) in the JAX package's order."""
    B, T = 2, 24
    x = np.random.default_rng(1).normal(size=(B, T, sum(STREAMS))).astype(
        np.float32)
    module, variables, port = _twins(
        multistream_config(**MULTISTREAM_CASES[case]), x)
    ref = np.asarray(module.apply(variables, jnp.asarray(x),
                                  method="inference"))
    got = port.inference(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=MODULE_ATOL)
    np.testing.assert_array_equal(got[..., :2], x[..., :2])
    np.testing.assert_array_equal(got[..., 8:10], x[..., 8:10])
    if case == "neither":
        np.testing.assert_array_equal(got, x)
    if case == "both":
        explicit = port.inference(torch.from_numpy(x), noise={
            "mgc": torch.from_numpy(_noise((B, T, 1))),
            "bap": torch.from_numpy(_noise((B, T, 3)))}).detach().numpy()
        np.testing.assert_array_equal(explicit, got)


def test_torch_to_flax_round_trips_the_postfilter_bitwise():
    x = np.zeros((1, 16, sum(STREAMS)), np.float32)
    _, variables, port = _twins(
        multistream_config(**MULTISTREAM_CASES["both"]), x)
    back = torch_to_flax(port)
    assert set(back) == {"params"}
    flat = jax.tree_util.tree_leaves_with_path(back["params"])
    ref = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    assert len(flat) == len(ref) == 18
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, ref[path])
    again = instantiate(multistream_config(**MULTISTREAM_CASES["both"]))
    flax_to_torch(again, back)
    for (n, a), (_, b) in zip(port.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), n


def test_moving_average_needs_a_longer_input():
    """The reflection pad of ``moving_average`` needs T > width // 2 (the
    engine pads to 512-frame buckets)."""
    z = torch.zeros(1, 4, 1)
    with pytest.raises(RuntimeError):
        postfilters.moving_average(z, 100)
    assert postfilters.moving_average(z, 5).shape == z.shape


# ------------------------------------------------------------- sptk
@pytest.mark.parametrize("fs,order", [(24000, 7), (48000, 59), (48000, 24)])
def test_mc2sp_matches_jax(fs, order):
    rng = np.random.default_rng(order)
    mc = rng.normal(0, 0.3, size=(9, order + 1))
    mc[:, 0] -= 3.0
    alpha = sptk.mcepalpha(fs)
    assert alpha == jax_sptk.mcepalpha(fs)
    fftlen = get_cheaptrick_fft_size(fs)
    got = sptk.mc2sp(mc, alpha, fftlen)
    ref = jax_sptk.mc2sp(mc, alpha, fftlen)
    assert got.shape == ref.shape == (9, fftlen // 2 + 1)
    np.testing.assert_allclose(got, ref, rtol=MC2SP_RTOL)
    np.testing.assert_allclose(sptk.freqt(mc, 30, alpha),
                               jax_sptk.freqt(mc, 30, alpha), rtol=1e-12)


# ------------------------------------------------------------ engines
def _tiny_postfilter(bap_dim):
    """The merged postfilter at tiny widths: mgc frame-wise noise smoothed
    over 100 frames, bap bin-wise over 5, as the shipped configs."""
    net = multistream_config(
        mgc=conv_config(kernel=(5, 5), noise_type="frame_wise",
                        smoothing_width=100),
        bap=conv_config(channels=2, kernel=(5, 1), smoothing_width=5),
        stream_sizes=[8, 1, 1, bap_dim])
    return {"netG": net, "stream_sizes": [8, 1, 1, bap_dim],
            "has_dynamic_features": [False] * 4, "num_windows": 1}


def _pack_single(model_dir, bap_dim=3):
    """The tiny single-track voice of tests/test_torch_svs_single.py with a
    merged postfilter, packed by the JAX package's ``pack_model``; the
    weights are the port's modules' seeded initial ones, carried to flax
    by ``torch_to_flax``."""
    timelag, duration, acoustic, ss = single_track_configs(bap_dim=bap_dim)
    cfgs = {"timelag": timelag, "duration": duration, "acoustic": acoustic,
            "postfilter": _tiny_postfilter(bap_dim)}
    variables = {}
    for k, (name, cfg) in enumerate(sorted(cfgs.items())):
        torch.manual_seed(k)
        variables[name] = torch_to_flax(instantiate(cfg["netG"]))
    mean = np.zeros(sum(ss))
    scale = np.ones(sum(ss)) * 0.1
    mean[ss[0]] = np.log(220.0)
    stats = {"timelag": (82, np.zeros(1), np.ones(1) * 2),
             "duration": (82, np.ones(1) * 10, np.ones(1) * 2),
             "acoustic": (86, mean, scale)}
    phases = tiny_phases(cfgs, stats, JaxMinMax, JaxStandard,
                         lambda ph: {"variables": variables[ph]})
    phases["postfilter"] = {
        "model_config": cfgs["postfilter"],
        "variables": variables["postfilter"],
        "out_scaler": JaxStandard(mean + 0.05, (scale * 1.5) ** 2,
                                  scale * 1.5)}
    glob = {"sample_rate": SR, "frame_period": 5, "feature_type": "world",
            "use_world_codec": True, "relative_f0": False}
    pack_model(model_dir, glob, HED, phases)
    return model_dir


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    return _pack_single(tmp_path_factory.mktemp("packed_postfilter"))


@pytest.fixture(scope="module")
def engines(packed):
    """(JAX engine, port engine) over one directory with a postfilter."""
    with traced_flax_inits():
        jax_engine = JaxSPSVS(packed)
    return jax_engine, SPSVS(packed, device="cpu")


@pytest.fixture(scope="module")
def timed(engines):
    jax_engine, engine = engines
    return (jax_engine.predict_timing(_short_labels(jax_hts, SECONDS)),
            engine.predict_timing(_short_labels(hts, SECONDS)))


def _snr(ref, got):
    err = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    return 10 * np.log10(np.sum(np.asarray(ref, np.float64) ** 2)
                         / max(np.sum(err ** 2), 1e-30))


def test_packed_postfilter_loads_every_flax_weight(engines):
    """``SPSVS(model_dir)`` loads ``postfilter_model`` (every flax leaf,
    or the loader raises) and ``out_postfilter_scaler``."""
    jax_engine, engine = engines
    module = engine.postfilter_model.module
    assert isinstance(module, postfilters.MultistreamPostFilter)
    assert isinstance(module.mgc_postfilter, postfilters.Conv2dPostFilter)
    assert module.mgc_postfilter.fc.out_features == 6
    assert module.lf0_postfilter is None
    np.testing.assert_array_equal(engine.postfilter_out_scaler.mean_,
                                  jax_engine.postfilter_out_scaler.mean_)
    assert engine.postfilter_model.bucket == gen.FRAME_BUCKET


POST_FILTER_TYPES = ["nnsvs", "merlin", "gv", "none"]


@pytest.mark.parametrize("post_filter_type", POST_FILTER_TYPES)
def test_postprocess_acoustic_matches_jax(engines, timed,
                                          post_filter_type):
    """The host postprocess of the same acoustic features under each
    postfilter: the same streams at ATOL."""
    (jax_engine, engine), (ref_dm, dm) = engines, timed
    acoustic = jax_engine.predict_acoustic(ref_dm)
    ref = jax_engine.postprocess_acoustic(acoustic, ref_dm,
                                          post_filter_type=post_filter_type)
    got = engine.postprocess_acoustic(acoustic, dm,
                                      post_filter_type=post_filter_type)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=ATOL)
    if post_filter_type in ("nnsvs", "merlin"):
        gv = engine.postprocess_acoustic(acoustic, dm, post_filter_type="gv")
        assert not np.allclose(got[0], gv[0], atol=1e-3)


@pytest.mark.parametrize("post_filter_type", POST_FILTER_TYPES)
def test_svs_matches_jax(engines, post_filter_type):
    """End to end with each postfilter, float32 output: the same length
    and dtype, and the waveform at SNR >= 40 dB (the same noise)."""
    jax_engine, engine = engines
    kw = {"post_filter_type": post_filter_type, "dtype": np.float32}
    ref, _ = jax_engine.svs(_short_labels(jax_hts, SECONDS), **kw)
    got, sr = engine.svs(_short_labels(hts, SECONDS), **kw)
    assert sr == SR and got.dtype == ref.dtype and got.shape == ref.shape
    assert _snr(ref, got) > SNR_DB, _snr(ref, got)


def test_svs_ensemble_nnsvs_matches_jax(engines):
    """``svs_ensemble(post_filter_type="nnsvs")`` takes the host
    postprocess: the same streams at ATOL, the same audio lengths and,
    with the same noise, waveforms at SNR >= 40 dB."""
    jax_engine, engine = engines
    secs = (SECONDS, 3.0)
    ref, _ = jax_engine.svs_ensemble(
        [_short_labels(jax_hts, s) for s in secs], post_filter_type="nnsvs",
        dtype=np.float32)
    got, _ = engine.svs_ensemble(
        [_short_labels(hts, s) for s in secs], post_filter_type="nnsvs",
        dtype=np.float32)
    assert not engine._fused_post_ok("nnsvs", [1000])
    assert "vocoder_device" in engine.last_stage_times
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert _snr(r, g) > SNR_DB, _snr(r, g)
    again, _ = engine.svs_ensemble(
        [_short_labels(hts, s) for s in secs], post_filter_type="nnsvs",
        dtype=np.float32)
    for a, g in zip(again, got):
        np.testing.assert_array_equal(a, g)


# -------------------------------------------------------- uncoded WORLD
def _uncoded_streams(rng, T, bap_dim):
    t = np.arange(T)[:, None]
    mgc = rng.normal(0, 0.05, size=(T, 8)).cumsum(axis=0) * 0.2
    mgc[:, 0] += -4.0
    lf0 = np.log(220.0) + 0.05 * np.sin(2 * np.pi * t / 40.0)
    vuv = np.ones((T, 1))
    vuv[T // 3: T // 3 + 15] = 0.0
    if bap_dim > 5:
        bap = rng.normal(0, 0.05, size=(T, bap_dim))
        bap[:, 0] -= 1.0
    else:
        bap = np.clip(-25 + rng.normal(0, 3, size=(T, bap_dim)), -60, 0)
    return mgc, lf0, vuv, bap


@pytest.mark.parametrize("use_world_codec,bap_dim",
                         [(False, 3), (False, 25), (True, 25)])
def test_world_params_and_synthesis_match_jax(use_world_codec, bap_dim):
    """``gen_world_params`` at ATOL (relative on the envelope), then
    ``synthesize`` and ``predict_waveform`` on the same parameters and
    noise at SNR >= 40 dB."""
    streams = _uncoded_streams(np.random.default_rng(bap_dim), 160, bap_dim)
    kw = {"vuv_threshold": 0.5, "use_world_codec": use_world_codec}
    ref = jax_gen.gen_world_params(*streams, SR, **kw)
    got = gen.gen_world_params(*streams, SR, **kw)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)
    np.testing.assert_allclose(got[2], ref[2], atol=ATOL)
    f0, sp, ap = ref
    noise = _noise((len(f0) * HOP,))
    ref_wav = np.asarray(jax_syn.synthesize(f0, sp, ap, SR, 5.0))
    got_wav = synthesis.synthesize(
        *(torch.from_numpy(np.asarray(a))[None] for a in (f0, sp, ap)),
        torch.from_numpy(noise)[None], SR, 5.0)[0].numpy()
    assert got_wav.shape == ref_wav.shape == (len(f0) * HOP,)
    assert _snr(ref_wav, got_wav) > SNR_DB, _snr(ref_wav, got_wav)
    ref_wav = jax_gen.predict_waveform(streams, sample_rate=SR,
                                       use_world_codec=use_world_codec)
    got_wav = gen.predict_waveform(streams, sample_rate=SR,
                                   use_world_codec=use_world_codec,
                                   device="cpu")
    assert got_wav.shape == ref_wav.shape
    assert _snr(ref_wav, got_wav) > SNR_DB, _snr(ref_wav, got_wav)


def test_minimum_phase_spectrum_matches_jax():
    power = np.exp(np.random.default_rng(5).normal(0, 1, (7, 129)))
    ref = np.asarray(jax_syn.minimum_phase_spectrum(
        jnp.asarray(power, jnp.float32), 256))
    got = synthesis.minimum_phase_spectrum(
        torch.from_numpy(power.astype(np.float32)), 256).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(np.abs(got) ** 2, power, rtol=1e-3)


@pytest.fixture(scope="module")
def mcep_engines(tmp_path_factory):
    """(JAX engine, port engine) over a pack whose acoustic model predicts
    25-dim mel-cepstral aperiodicity."""
    model_dir = _pack_single(tmp_path_factory.mktemp("mcep_ap"), bap_dim=25)
    with traced_flax_inits():
        jax_engine = JaxSPSVS(model_dir)
    return jax_engine, SPSVS(model_dir, device="cpu")


@pytest.mark.parametrize("pack", ["uncoded", "mcep_aperiodicity"])
def test_uncoded_packs_render_as_jax(engines, mcep_engines, monkeypatch,
                                     pack):
    """A pack with ``use_world_codec: false`` (the postfilter pack's config
    so set) and one with mel-cepstral aperiodicity render through ``svs``
    with the learned postfilter and through ``svs_ensemble``: audio of
    JAX's length and dtype, at SNR >= 40 dB with the same noise."""
    if pack == "uncoded":
        for e in engines:
            monkeypatch.setitem(e.config, "use_world_codec", False)
    jax_engine, engine = engines if pack == "uncoded" else mcep_engines
    ref, _ = jax_engine.svs(_short_labels(jax_hts, SECONDS),
                            post_filter_type="nnsvs", dtype=np.float32)
    got, _ = engine.svs(_short_labels(hts, SECONDS), post_filter_type="nnsvs",
                        dtype=np.float32)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert _snr(ref, got) > SNR_DB, _snr(ref, got)
    secs = (SECONDS, 3.0)
    ref, _ = jax_engine.svs_ensemble(
        [_short_labels(jax_hts, s) for s in secs], dtype=np.float32)
    got, _ = engine.svs_ensemble([_short_labels(hts, s) for s in secs],
                                 dtype=np.float32)
    assert "vocoder_device" in engine.last_stage_times
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert _snr(r, g) > SNR_DB, _snr(r, g)
