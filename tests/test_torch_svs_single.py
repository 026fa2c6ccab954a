"""The port's single-singer serving, ``SPSVS.svs`` and ``svs_ensemble`` on
a single-track pack, against the JAX engine, both opening one packed
directory written by the JAX package's ``pack_model``, at tiny widths (a
biLSTM of 8, AR cell 8 at r = 4, FFConvLSTM decoders of 4-8 units, VP-MDN
timing models) on the first seconds of the fixture.

Durations must match exactly, acoustic features and streams at ATOL
(float32 on both sides with other summation orders) and the host
postprocess of one float waveform at 1e-6.  The AR decoder's prenet
dropout cannot reproduce jax.random's bits, so ``prenet_dropout = 0``.
The vocoder's noise differs between frameworks, so the vocoder stage is
compared by SNR with the port's noise fed to the JAX vocoder (the 40 dB
bound of tests/test_torch_world.py), and rendered audio by sample rate,
dtype and length.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ensemble_svs_with_interactions_tpu import gen as jax_gen
from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
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
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
from tests.test_torch_svs import _short_labels
from tests.test_torch_svs import run_cached
from tests.test_torch_svs import tiny_phases
from tests.test_torch_svs import traced_flax_inits
from tests.util import HED
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

SR = 24000
ATOL = 1e-4
WAV_ATOL = 1e-6
SNR_DB = 40.0
PKG = "ensemble_svs_with_interactions_tpu.models"
SECONDS = 4.0


def single_track_configs(mgc_dim=8, bap_dim=3):
    """(timelag, duration, acoustic) configs of the tiny single-track
    voice: the layout of the shipped ``acoustic_multistream_ar_f0.yaml``
    and ``{timelag,duration}_vp_mdn.yaml`` at tiny widths."""
    ss = [mgc_dim, 1, 1, bap_dim]
    timing = {
        "netG": {"_target_": f"{PKG}.VariancePredictor", "in_dim": 82,
                 "out_dim": 1, "num_layers": 2, "hidden_dim": 8,
                 "kernel_size": 3, "use_mdn": True, "num_gaussians": 2},
        "stream_sizes": [1], "has_dynamic_features": [False],
        "num_windows": 1,
    }
    dec = {"in_dim": 10, "ff_hidden_dim": 8, "conv_hidden_dim": 8,
           "num_lstm_layers": 2}
    lf0 = {"in_lf0_idx": 51, "in_lf0_min": 4.5, "in_lf0_max": 6.5,
           "out_lf0_mean": float(np.log(220.0)), "out_lf0_scale": 0.1}
    acoustic = {
        "netG": {
            "_target_": f"{PKG}.acoustic.MultistreamSeparateF0ParametricModel",
            "in_dim": 86, "out_dim": sum(ss), "stream_sizes": ss,
            "reduction_factor": 4, "in_rest_idx": 0, "out_lf0_idx": mgc_dim,
            **lf0,
            "encoder": {
                "_target_": f"{PKG}.LSTMEncoder", "in_dim": 86,
                "hidden_dim": 8, "out_dim": 8, "num_layers": 2,
                "in_ph_start_idx": 3, "in_ph_end_idx": 50, "embed_dim": 8,
            },
            "lf0_model": {
                "_target_": f"{PKG}.acoustic.BiLSTMResF0NonAttentiveDecoder",
                "in_dim": 86, "out_dim": 1, "ff_hidden_dim": 8,
                "conv_hidden_dim": 8, "lstm_hidden_dim": 8,
                "num_lstm_layers": 2, "decoder_layers": 1,
                "decoder_hidden_dim": 8, "prenet_layers": 0,
                "prenet_hidden_dim": 4, "prenet_dropout": 0.0,
                "scaled_tanh": True, "zoneout": 0.0, "reduction_factor": 4,
                "downsample_by_conv": True, "out_lf0_idx": 0, **lf0,
                "in_ph_start_idx": 3, "in_ph_end_idx": 50, "embed_dim": 8,
            },
            "mgc_model": {"_target_": f"{PKG}.FFConvLSTM", **dec,
                          "lstm_hidden_dim": 8, "out_dim": ss[0]},
            "vuv_model": {"_target_": f"{PKG}.FFConvLSTM", **dec,
                          "lstm_hidden_dim": 4, "out_dim": ss[2]},
            "bap_model": {"_target_": f"{PKG}.FFConvLSTM", **dec,
                          "lstm_hidden_dim": 6, "out_dim": ss[3]},
        },
        "stream_sizes": ss, "has_dynamic_features": [False] * 4,
        "num_windows": 1,
    }
    return timing, dict(timing), acoustic, ss


def tiny_single_model():
    """(global config, {phase: config}, {phase: flax variables as numpy},
    {phase: (in_dim, out mean, out scale)})."""
    import jax

    timelag, duration, acoustic, ss = single_track_configs()
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "prenet": jax.random.PRNGKey(2)}
    T = 8

    def init_timing(cfg):
        return jax_instantiate(cfg["netG"]).init(
            rngs, jnp.zeros((1, T, 82)), jnp.asarray([T]))

    def init():
        return jax.tree_util.tree_map(np.asarray, {
            "timelag": init_timing(timelag),
            "duration": init_timing(duration),
            "acoustic": jax_instantiate(acoustic["netG"]).init(
                rngs, jnp.zeros((1, T, 86)), jnp.asarray([T]),
                jnp.zeros((1, T, sum(ss))))})

    variables = run_cached("tiny_single_variables", init)
    mean = np.zeros(sum(ss))
    scale = np.ones(sum(ss)) * 0.1
    mean[ss[0]] = np.log(220.0)
    stats = {"timelag": (82, np.zeros(1), np.ones(1) * 2),
             "duration": (82, np.ones(1) * 10, np.ones(1) * 2),
             "acoustic": (86, mean, scale)}
    cfgs = {"timelag": timelag, "duration": duration, "acoustic": acoustic}
    glob = {"sample_rate": SR, "frame_period": 5, "feature_type": "world",
            "use_world_codec": True, "relative_f0": False}
    return glob, cfgs, variables, stats


def _pack(model_dir, model):
    glob, cfgs, variables, stats = model
    pack_model(model_dir, glob, HED, tiny_phases(
        cfgs, stats, JaxMinMax, JaxStandard,
        lambda ph: {"variables": variables[ph]}))
    return model_dir


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine) over one single-track directory."""
    model_dir = _pack(tmp_path_factory.mktemp("packed_single"),
                      tiny_single_model())
    with traced_flax_inits():
        jax_engine = JaxSPSVS(model_dir)
    return jax_engine, SPSVS(model_dir, device="cpu")


@pytest.fixture(scope="module")
def timed(engines):
    """The duration-modified labels of both engines on the short fixture."""
    jax_engine, engine = engines
    return (jax_engine.predict_timing(_short_labels(jax_hts, SECONDS)),
            engine.predict_timing(_short_labels(hts, SECONDS)))


@pytest.fixture(scope="module")
def acoustics(engines, timed):
    """The acoustic features of both engines on their timed labels."""
    (jax_engine, engine), (ref_dm, dm) = engines, timed
    return jax_engine.predict_acoustic(ref_dm), engine.predict_acoustic(dm)


def _same_times(got, ref):
    assert list(got.start_times) == list(ref.start_times)
    assert list(got.end_times) == list(ref.end_times)


def test_predict_timing_matches_jax(engines, timed):
    """Start and end times exactly, for one track and for a batch of
    tracks of different lengths."""
    jax_engine, engine = engines
    _same_times(*timed[::-1])
    secs = (SECONDS, 2.5)
    ref = jax_gen.predict_timing_batch(
        [_short_labels(jax_hts, s) for s in secs], jax_engine.binary_dict,
        jax_engine.numeric_dict, jax_engine.timelag_model,
        jax_engine.in_timelag_scaler, jax_engine.out_timelag_scaler,
        jax_engine.duration_model, jax_engine.in_duration_scaler,
        jax_engine.out_duration_scaler, frame_period=5)
    got = engine.predict_timing_batch([_short_labels(hts, s) for s in secs])
    for g, r in zip(got, ref):
        _same_times(g, r)
    _same_times(got[0], timed[1])


def test_predict_acoustic_matches_jax(acoustics):
    ref, got = acoustics
    assert got.shape == ref.shape and got.shape[1] == 13
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_predict_acoustic_with_style_shift_matches_jax(engines, timed):
    """``svs(style_shift=k)`` shifts the score pitch of the acoustic
    model's input by 100 k cents (and the output back)."""
    (jax_engine, engine), (ref_dm, dm) = engines, timed
    ref = jax_engine.predict_acoustic(ref_dm, f0_shift_in_cent=200)
    got = engine.predict_acoustic(dm, f0_shift_in_cent=200)
    np.testing.assert_allclose(got, ref, atol=ATOL)


POSTPROCESS_CASES = {
    "gv": {},
    "none": {"post_filter_type": "none"},
    "off": {"post_filter_type": "off"},
    "unset": {"post_filter_type": None},
    "fill_silence_to_rest": {"fill_silence_to_rest": True},
    "force_fix_vuv": {"force_fix_vuv": True},
    "no_smoothing": {"trajectory_smoothing": False},
    "style_shift": {"f0_shift_in_cent": -150.0},
    "cutoffs": {"trajectory_smoothing_cutoff": 30,
                "trajectory_smoothing_cutoff_f0": 10},
}


@pytest.mark.parametrize("case", sorted(POSTPROCESS_CASES))
def test_postprocess_acoustic_matches_jax(engines, timed, acoustics, case):
    """The host postprocess of the same acoustic features (JAX's) gives
    the same streams at ATOL under each option."""
    (jax_engine, engine), (ref_dm, dm) = engines, timed
    kw = POSTPROCESS_CASES[case]
    ref = jax_engine.postprocess_acoustic(acoustics[0], ref_dm, **kw)
    got = engine.postprocess_acoustic(acoustics[0], dm, **kw)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=ATOL)


def test_relative_f0_static_features_match_jax(engines, timed, acoustics):
    """The relative-F0 branch: the score lf0 is added back to the
    predicted difference before V/UV gating."""
    (jax_engine, engine), (ref_dm, dm) = engines, timed
    cfg = engine.acoustic_model.config
    args = (acoustics[0], jax_engine.binary_dict, jax_engine.numeric_dict,
            cfg.stream_sizes, cfg.has_dynamic_features)
    kw = {"num_windows": 1, "relative_f0": True, "vuv_threshold": 0.5}
    ref = jax_gen.gen_spsvs_static_features(ref_dm, *args, **kw)
    got = gen.gen_spsvs_static_features(dm, *args, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL)


WAVEFORM_CASES = {
    "int16": {"dtype": np.int16},
    "float32": {"dtype": np.float32},
    "float64": {"dtype": np.float64},
    "peak_norm": {"peak_norm": True, "dtype": np.float32},
    "loudness_norm": {"loudness_norm": True, "target_loudness": -26.0,
                      "dtype": np.float64},
    "skip_bandpass": {"skip_bandpass": True, "dtype": np.int16},
}


@pytest.mark.parametrize("case", sorted(WAVEFORM_CASES))
def test_postprocess_waveform_matches_jax(case):
    rng = np.random.default_rng(3)
    wav = (0.3 * np.sin(np.arange(9600) * 0.05)
           + rng.normal(0, 0.05, 9600)).astype(np.float32)
    kw = WAVEFORM_CASES[case]
    ref = jax_gen.postprocess_waveform(wav, SR, **kw)
    got = gen.postprocess_waveform(wav, SR, **kw)
    assert got.dtype == ref.dtype == np.dtype(kw["dtype"])
    np.testing.assert_allclose(got.astype(np.float64),
                               ref.astype(np.float64), atol=WAV_ATOL)


def _snr(ref, got):
    err = got - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-30))


def test_vocoder_stage_matches_jax(engines, timed, acoustics):
    """``predict_waveform`` on the port's streams against the JAX vocoder
    on the same streams, padded the same way, with the port's noise."""
    (_, engine), (_, dm) = engines, timed
    streams = engine.postprocess_acoustic(acoustics[1], dm)
    got = engine.predict_waveform(streams)
    T = len(streams[1])
    T_pad = gen._round_up(T, gen.FRAME_BUCKET)
    hop = SR * 5 // 1000
    noise = gen.vocoder_noise(1, T_pad * hop, "cpu").numpy()
    padded = [a[None] for a in gen.pad_streams(streams, T_pad)]
    ref = np.asarray(jax_syn._synthesize_from_streams_impl(
        *(jnp.asarray(a) for a in (*padded, noise)), SR, hop,
        get_cheaptrick_fft_size(SR), 0.5, 0.0))[0, : T * hop]
    assert got.shape == ref.shape == (T * hop,)
    assert _snr(ref, got) > SNR_DB, _snr(ref, got)


SVS_CASES = {"int16": {}, "float32": {"dtype": np.float32},
             "segmented": {"segmented_synthesis": True}}


@pytest.mark.parametrize("case", sorted(SVS_CASES))
def test_svs_matches_jax(engines, case):
    """End to end: the sample rate, dtype and length of JAX's rendering,
    audible content, and the stage times."""
    jax_engine, engine = engines
    kw = SVS_CASES[case]
    seconds = 8.0 if case == "segmented" else SECONDS
    ref, sr_ref = jax_engine.svs(_short_labels(jax_hts, seconds), **kw)
    wav, sr = engine.svs(_short_labels(hts, seconds), **kw)
    assert sr == sr_ref == SR
    assert wav.dtype == ref.dtype and wav.shape == ref.shape
    assert np.abs(wav.astype(np.float64)).max() > 0
    assert set(engine.last_stage_times) == {
        "timing", "acoustic", "postprocess_acoustic", "vocoder",
        "postprocess_waveform"}
    assert engine.last_rtf > 0
    if case == "segmented":
        dm = engine.predict_timing(_short_labels(hts, seconds))
        assert len(hts.segment_labels(dm)) > 1


def test_svs_on_multitrack_pack_raises(tmp_path):
    """``svs`` refuses a multitrack pack with ValueError, as the JAX
    engine does: it renders through ``svs_ensemble``.  (The tiny flagship
    of the port's benches, packed by the port's ``pack_model``.)"""
    import chip_smoke

    weights = chip_smoke.random_state_dicts(
        chip_smoke.flagship_phases(tiny=True)[1], 0)
    chip_smoke.pack_flagship(tmp_path, weights, tiny=True)
    with pytest.raises(ValueError, match="svs_ensemble"):
        SPSVS(tmp_path, device="cpu").svs(_short_labels(hts))


def test_svs_ensemble_single_track_matches_jax(engines):
    """The single-track branch: durations exactly, the device-path streams
    at ATOL, and float output of JAX's length and dtype."""
    jax_engine, engine = engines
    N = 3
    secs = (SECONDS, 3.0, 3.5)
    ref_dm = jax_gen.predict_timing_batch(
        [_short_labels(jax_hts, s) for s in secs], jax_engine.binary_dict,
        jax_engine.numeric_dict, jax_engine.timelag_model,
        jax_engine.in_timelag_scaler, jax_engine.out_timelag_scaler,
        jax_engine.duration_model, jax_engine.in_duration_scaler,
        jax_engine.out_duration_scaler, frame_period=5)
    dm = engine.predict_timing_batch([_short_labels(hts, s) for s in secs])
    for g, r in zip(dm, ref_dm):
        _same_times(g, r)
    ref_feats, ref_raw = jax_engine._frame_features(ref_dm)
    feats, raw = engine._frame_features(dm)
    ref_out, lengths = jax_engine.acoustic_model.inference_batch(
        ref_feats, device_out=True)
    out, lengths_port = engine.acoustic_model.inference_batch(
        feats, device_out=True)
    np.testing.assert_array_equal(lengths_port, lengths)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL)
    ref_streams = jax_engine._fused_postprocess(ref_out, lengths, ref_raw,
                                                "gv")
    streams = engine._fused_postprocess(out, lengths, raw, "gv")
    for r, g in zip(ref_streams, streams):
        r, g = np.asarray(r), g.numpy()
        for i in range(N):
            np.testing.assert_allclose(g[i, : lengths[i]],
                                       r[i, : lengths[i]], atol=ATOL)

    labels = [_short_labels(hts, s) for s in secs]
    ref_wavs, sr_ref = jax_engine.svs_ensemble(
        [_short_labels(jax_hts, s) for s in secs], dtype=np.float32)
    wavs, sr = engine.svs_ensemble(labels, dtype=np.float32)
    assert sr == sr_ref == SR
    for w, r in zip(wavs, ref_wavs):
        assert w.dtype == r.dtype == np.float32 and w.shape == r.shape
        assert 0 < np.abs(w).max() <= 1.0
    ints, _ = engine.svs_ensemble(labels)
    hop = SR * 5 // 1000
    for w, n in zip(ints, lengths):
        assert w.dtype == np.int16 and len(w) == n * hop


def test_svs_ensemble_host_path_matches_jax(engines, monkeypatch):
    """With the device postprocess refused, both engines take the host
    postprocess: the same streams at ATOL, and audio of JAX's length and
    dtype."""
    jax_engine, engine = engines
    monkeypatch.setenv("ESVS_DISABLE_FUSED_POST", "1")
    monkeypatch.setattr(engine, "_fused_post_ok", lambda *a: False)
    secs = (SECONDS, 3.0)
    ref_dm = jax_gen.predict_timing_batch(
        [_short_labels(jax_hts, s) for s in secs], jax_engine.binary_dict,
        jax_engine.numeric_dict, jax_engine.timelag_model,
        jax_engine.in_timelag_scaler, jax_engine.out_timelag_scaler,
        jax_engine.duration_model, jax_engine.in_duration_scaler,
        jax_engine.out_duration_scaler, frame_period=5)
    dm = engine.predict_timing_batch([_short_labels(hts, s) for s in secs])
    ref_ac = [jax_engine.predict_acoustic(lab) for lab in ref_dm]
    ref = jax_engine._postprocess_batch(ref_dm, ref_ac, "gv")
    got = engine._postprocess_batch(dm, ref_ac, "gv", [None] * len(dm))
    for g_streams, r_streams in zip(got, ref):
        for g, r in zip(g_streams, r_streams):
            np.testing.assert_allclose(g, r, atol=ATOL)
    for dtype in (np.int16, np.float64):
        ref_wavs, _ = jax_engine.svs_ensemble(
            [_short_labels(jax_hts, s) for s in secs], dtype=dtype)
        wavs, _ = engine.svs_ensemble(
            [_short_labels(hts, s) for s in secs], dtype=dtype)
        for w, r in zip(wavs, ref_wavs):
            assert w.dtype == r.dtype and w.shape == r.shape


# case -> (call, what it raises): a neural vocoder type on a pack with no
# packed vocoder, and mel features on the WORLD vocoder, raise ValueError,
# as the JAX engine does; unported options raise NotImplementedError
# naming their JAX module (none is left: the vibrato streams and
# ``vib_model`` are held against JAX in tests/test_torch_streaming.py)
REFUSED = {
    "pwg": (lambda e: e.svs(_short_labels(hts), vocoder_type="pwg"),
            (ValueError, "packed neural vocoder")),
    "usfgan": (lambda e: e.svs_ensemble([_short_labels(hts)], "usfgan"),
               (ValueError, "packed neural vocoder")),
    "melf0": (lambda e: gen.predict_waveform(
        (np.zeros((40, 80)), np.zeros((40, 1)), np.ones((40, 1))),
        feature_type="melf0", device="cpu"),
        (ValueError, "invalid feature type for WORLD vocoder")),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_options_raise_naming_their_module(engines, case):
    fn, module = REFUSED[case]
    exc, match = (module if isinstance(module, tuple)
                  else (NotImplementedError, module.replace(".", r"\.")))
    with pytest.raises(exc, match=match):
        fn(engines[1])


def test_single_track_modules_load_every_flax_weight(engines):
    """The encoder, the lf0 model and the decoders carry the flax scope
    names: the pack's variables load with nothing left over (the loader
    raises otherwise), and the port's modules are the single-track
    classes."""
    from ensemble_svs_with_interactions_tpu_torch.models import LSTMEncoder
    from ensemble_svs_with_interactions_tpu_torch.models.acoustic import (
        BiLSTMResF0NonAttentiveDecoder,
        MultistreamSeparateF0ParametricModel,
    )

    module = engines[1].acoustic_model.module
    assert isinstance(module, MultistreamSeparateF0ParametricModel)
    assert isinstance(module.encoder, LSTMEncoder)
    assert isinstance(module.lf0_model, BiLSTMResF0NonAttentiveDecoder)
    assert not engines[1].is_multitrack
    names = {n.split(".")[1] for n, _ in module.lf0_model.named_parameters(
        prefix="lf0")}
    assert names == {"PhonemeContextEmbedding_0", "_SinsyEncoder_0",
                     "conv_downsample", "ar_core"}
    # zoneout builds too (its cells step in PyTorch) and matches JAX,
    # teacher-forced and free-running, at evaluation (zoneout's blend)
    import torch

    from tests.test_torch_npss_ar import LENGTHS, RNGS, close, inputs, targets
    from tests.test_torch_npss_ar import twins as npss_twins

    net = {"_target_": "ensemble_svs_with_interactions_tpu.models.acoustic."
           "BiLSTMResF0NonAttentiveDecoder", "in_dim": 86, "zoneout": 0.1,
           "prenet_layers": 0, "prenet_dropout": 0.0,
           "downsample_by_conv": True, "reduction_factor": 4,
           "ff_hidden_dim": 8, "conv_hidden_dim": 6, "lstm_hidden_dim": 4,
           "num_lstm_layers": 1, "decoder_layers": 1,
           "decoder_hidden_dim": 5, "out_dim": 1, "in_lf0_idx": 51,
           "out_lf0_idx": 0}
    port, jm, variables = npss_twins(net)
    assert isinstance(port, BiLSTMResF0NonAttentiveDecoder)
    x, y = inputs(86, seed=2), targets(1, seed=2)
    with torch.no_grad():
        close(port(torch.from_numpy(x), torch.from_numpy(LENGTHS),
                   y=torch.from_numpy(y)),
              jm.apply(variables, x, LENGTHS, y, rngs=RNGS))
        close(port.inference(torch.from_numpy(x), torch.from_numpy(LENGTHS)),
              jm.apply(variables, x, LENGTHS, method=jm.inference,
                       rngs=RNGS))
