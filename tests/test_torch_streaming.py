"""The port's phrase streaming (``SPSVS.svs_streaming``) and vibrato streams
against the JAX package's, at tiny widths on the first seconds of the
fixture.

Streaming opens the single-track pack of ``tests/test_torch_svs_single``
(the stock voice's layout: biLSTM encoder, AR lf0 decoder without prenet
dropout, FFConvLSTM decoders) in both engines: the chunks' count and
lengths exactly, each chunk at 40 dB SNR with the port's WORLD noise fed
to the JAX vocoder (the AR lf0 decoder runs free, so streams are held by
SNR, as the waveforms of ``tests/test_torch_svs_single.py``), and the
port's chunks bitwise equal at every pipeline depth.  The vibrato branch
of ``gen.gen_spsvs_static_features`` (a Hz difference stream, or the sine
vibrato's amplitude, rate and flags) is host NumPy in float64, held at
1e-12; a pack whose acoustic model predicts the six streams renders
through both engines' ``svs()`` at 40 dB.  ``vib_model`` is accepted and
unused, as the JAX model's ``setup`` does.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu import gen as jax_gen
from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
from ensemble_svs_with_interactions_tpu.ops import pitch as jax_pitch
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
from ensemble_svs_with_interactions_tpu_torch.ops import (
    lstm_recurrence as lr,
    pitch,
)
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from tests.test_torch_svs import _short_labels
from tests.test_torch_svs import run_cached
from tests.test_torch_svs import tiny_phases
from tests.test_torch_svs import traced_flax_inits
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)
from tests.test_torch_svs_single import SR
from tests.test_torch_svs_single import _pack
from tests.test_torch_svs_single import single_track_configs
from tests.test_torch_svs_single import tiny_single_model
from tests.util import HED

SNR_DB = 40.0
ATOL = 1e-4
F64_ATOL = 1e-12
SECONDS = 8.0  # several rest-delimited segments
PKG = "ensemble_svs_with_interactions_tpu.models"
VIB_SS = [8, 1, 1, 3, 2, 1]  # mgc, lf0, vuv, bap, (m_a, m_f), flags


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    err = got - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def port_vocoder_noise():
    """The JAX vocoder draws the port's ``vocoder_noise`` (module-scoped, so
    the module's rendering fixtures see it)."""
    def normal(key, shape, dtype=jnp.float32):
        n = gen.vocoder_noise(1, int(np.prod(shape)), "cpu").numpy()
        return jnp.asarray(n.reshape(shape), dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        yield


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine) over the tiny single-track pack."""
    model_dir = _pack(tmp_path_factory.mktemp("packed_stream"),
                      tiny_single_model())
    with traced_flax_inits():
        jax_engine = JaxSPSVS(model_dir)
    return jax_engine, SPSVS(model_dir, device="cpu")


@pytest.fixture(scope="module")
def streamed(engines):
    """Both engines' float32 chunks of the fixture's first SECONDS."""
    jax_engine, engine = engines
    return (list(jax_engine.svs_streaming(_short_labels(jax_hts, SECONDS))),
            list(engine.svs_streaming(_short_labels(hts, SECONDS))))


def test_svs_streaming_matches_jax(engines, streamed):
    """As many chunks as segments, each of JAX's length and dtype, each at
    SNR_DB."""
    ref, got = streamed
    _, engine = engines
    dm = engine.predict_timing(_short_labels(hts, SECONDS))
    assert len(got) == len(ref) == len(hts.segment_labels(dm)) > 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float32 and g.shape == r.shape
        assert _snr(r, g) > SNR_DB, _snr(r, g)


def test_svs_streaming_depth_is_bitwise_invisible(engines, streamed):
    """Pipelining does not change the numerics: depths 1 and 3 give the
    default depth's chunks bit for bit."""
    _, engine = engines
    for depth in (1, 3):
        chunks = list(engine.svs_streaming(_short_labels(hts, SECONDS),
                                           pipeline_depth=depth))
        assert len(chunks) == len(streamed[1])
        for a, b in zip(chunks, streamed[1]):
            assert np.array_equal(a, b)


def test_svs_streaming_int16_gain_and_style_shift(engines):
    """int16 chunks clip the float64 chunk times ``gain`` at full scale,
    and match JAX's with a style shift and a gain at SNR_DB."""
    jax_engine, engine = engines
    kw = {"gain": 3.0, "style_shift": 2}
    got = list(engine.svs_streaming(_short_labels(hts, SECONDS),
                                    dtype=np.int16, **kw))
    f64 = list(engine.svs_streaming(_short_labels(hts, SECONDS),
                                    dtype=None, **kw))
    ref = list(jax_engine.svs_streaming(_short_labels(jax_hts, SECONDS),
                                        dtype=np.int16, **kw))
    assert len(got) == len(f64) == len(ref)
    for g, f, r in zip(got, f64, ref):
        assert g.dtype == r.dtype == np.int16 and f.dtype == np.float64
        assert np.array_equal(
            g, (np.clip(f, -1.0, 1.0) * 32767.0).astype(np.int16))
        assert g.shape == r.shape and _snr(r, g) > SNR_DB


def test_svs_streaming_refuses_a_multitrack_pack(tmp_path):
    """A multitrack pack raises JAX's ValueError at the first chunk (the
    tiny flagship of the port's benches, packed by the port's
    ``pack_model``)."""
    import chip_smoke

    weights = chip_smoke.random_state_dicts(
        chip_smoke.flagship_phases(tiny=True)[1], 0)
    chip_smoke.pack_flagship(tmp_path, weights, tiny=True)
    chunks = SPSVS(tmp_path, device="cpu").svs_streaming(_short_labels(hts))
    with pytest.raises(ValueError, match="streaming is single-track"):
        next(chunks)


def test_launch_counts_hold_under_threads():
    """The kernels' launch counts are exact when renders on several threads
    launch at once."""
    before = lr.lstm_recurrence.launches
    width_before = lr.lstm_recurrence.launches_by_width[7]
    n, threads = 20000, 8

    def launch():
        for _ in range(n):
            lr._count(lr.lstm_recurrence, 7)

    ts = [threading.Thread(target=launch) for _ in range(threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert lr.lstm_recurrence.launches - before == n * threads
    assert lr.lstm_recurrence.launches_by_width[7] - width_before == (
        n * threads)
    lr.lstm_recurrence.launches = before
    del lr.lstm_recurrence.launches_by_width[7]


# ------------------------------------------------------------- vibrato
def _vibrato_features(n_streams: int, T: int, seed: int = 0):
    """Denormalized static features of T frames with vibrato streams: the
    amplitude around 60 cents, the rate around 5.5 Hz, the flags on over
    runs of frames."""
    rng = np.random.default_rng(seed)
    ss = VIB_SS[:n_streams] if n_streams == 6 else [8, 1, 1, 3, 1]
    x = rng.normal(0, 0.3, (T, sum(ss)))
    x[:, 8] = np.log(220.0) + 0.05 * rng.normal(size=T)
    x[:, 9] = (rng.random(T) > 0.2).astype(np.float64)
    if n_streams == 5:
        x[:, 13] = 3.0 * rng.normal(size=T)  # Hz
    else:
        x[:, 13] = 60.0 + 40.0 * rng.normal(size=T)
        x[:, 14] = 5.5 + 2.0 * rng.normal(size=T)
        x[:, 15] = np.repeat(rng.random(T // 40 + 1), 40)[:T]
    return x, ss


VIBRATO_CASES = {
    "diff_hz": (5, {}),
    "diff_hz_relative": (5, {"relative_f0": True, "vibrato_scale": 0.5}),
    "sine": (6, {}),
    "sine_relative": (6, {"relative_f0": True}),
    "sine_scaled_fixed_vuv": (6, {"vibrato_scale": 1.7,
                                  "force_fix_vuv": True}),
}


@pytest.mark.parametrize("case", sorted(VIBRATO_CASES))
def test_vibrato_static_features_match_jax(case):
    """Both vibrato layouts through ``gen_spsvs_static_features`` at 1e-12:
    five streams add ``vibrato_scale`` times the difference stream (Hz)
    to F0; six gate (amplitude, rate) by the flags and re-synthesize a
    sine vibrato."""
    n_streams, kw = VIBRATO_CASES[case]
    labels = _short_labels(hts, 4.0)
    binary_dict, numeric_dict = hts.load_question_set(HED)
    T = int(labels.end_times[-1] // 50000)
    x, ss = _vibrato_features(n_streams, T)
    args = (x, binary_dict, numeric_dict, ss, [False] * len(ss))
    kw = {"num_windows": 1, "relative_f0": False, "vuv_threshold": 0.5, **kw}
    ref = jax_gen.gen_spsvs_static_features(
        _short_labels(jax_hts, 4.0), *args, **kw)
    got = gen.gen_spsvs_static_features(labels, *args, **kw)
    plain = gen.gen_spsvs_static_features(labels, x[:, :13], binary_dict,
                                          numeric_dict, ss[:4], [False] * 4,
                                          **kw)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype == np.float64
        np.testing.assert_allclose(g, r, rtol=0, atol=F64_ATOL)
    assert np.abs(got[1] - plain[1]).max() > 1e-3  # the vibrato moved lf0


def test_gen_sine_vibrato_matches_jax():
    rng = np.random.default_rng(1)
    T = 600
    f0 = 200.0 + 20 * rng.random(T)
    f0[100:130] = 0
    f0[400:] = 0
    m_a = np.where((np.arange(T) // 50) % 2 == 0, 80.0 + rng.random(T), 0.0)
    m_f = 2.0 + 8 * rng.random(T)
    for scale in (1.0, 0.3):
        np.testing.assert_allclose(
            pitch.gen_sine_vibrato(f0, 200, m_a, m_f, scale),
            jax_pitch.gen_sine_vibrato(f0, 200, m_a, m_f, scale),
            rtol=0, atol=F64_ATOL)


def test_vib_model_is_accepted_as_in_jax():
    """The single-track model with a non-null ``vib_model`` and
    ``vib_flags_model`` builds as JAX's does and, with the same weights,
    gives JAX's output (the JAX model's ``setup`` ignores both fields); the
    multitrack model takes both fields too."""
    import chip_smoke

    net = single_track_configs()[2]["netG"]
    net = dict(net, vib_model=net["vuv_model"],
               vib_flags_model=net["vuv_model"])
    variables = tiny_single_model()[2]["acoustic"]
    module = instantiate(net)
    flax_to_torch(module, variables)
    plain = instantiate(single_track_configs()[2]["netG"])
    assert set(module.state_dict()) == set(plain.state_dict())
    rng = np.random.default_rng(0)
    T = 24
    x = rng.random((1, T, 86)).astype(np.float32)
    ref = jax_instantiate(net).apply(
        variables, jnp.asarray(x), jnp.asarray([T]), method="inference",
        rngs={"prenet": jax.random.PRNGKey(0)})  # prenet dropout is 0
    with torch.no_grad():
        got = module.inference(torch.from_numpy(x), torch.as_tensor([T]),
                               generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    multi = chip_smoke.flagship_acoustic_config(tiny=True)[0]["netG"]
    assert "MultiTrack" in multi["_target_"]
    built = instantiate(dict(multi, vib_model=None, vib_flags_model=None))
    assert set(built.state_dict()) == set(instantiate(multi).state_dict())


def _six_stream_pack(model_dir):
    """A single-track pack whose FFConvLSTM acoustic model predicts the six
    static streams VIB_SS, with the tiny voice's timing models, written by
    the JAX package's ``pack_model``."""
    glob, cfgs, variables, stats = tiny_single_model()
    ac = {"netG": {"_target_": f"{PKG}.FFConvLSTM", "in_dim": 86,
                   "ff_hidden_dim": 8, "conv_hidden_dim": 8,
                   "lstm_hidden_dim": 4, "out_dim": sum(VIB_SS)},
          "stream_sizes": VIB_SS, "has_dynamic_features": [False] * 6,
          "num_windows": 1}

    def init():
        return jax.tree_util.tree_map(np.asarray, jax_instantiate(
            ac["netG"]).init({"params": jax.random.PRNGKey(3)},
                             jnp.zeros((1, 8, 86)), jnp.asarray([8])))

    mean = np.zeros(sum(VIB_SS))
    scale = np.full(sum(VIB_SS), 0.1)
    mean[8], mean[9] = np.log(220.0), 1.0          # lf0, voiced
    mean[13:16], scale[13:16] = (60.0, 5.5, 0.6), (20.0, 1.0, 0.5)
    cfgs = dict(cfgs, acoustic=ac)
    variables = dict(variables,
                     acoustic=run_cached("six_stream_variables", init))
    stats = dict(stats, acoustic=(86, mean, scale))
    pack_model(model_dir, glob, HED, tiny_phases(
        cfgs, stats, JaxMinMax, JaxStandard,
        lambda ph: {"variables": variables[ph]}))
    return model_dir


def test_six_stream_voice_svs_matches_jax(tmp_path):
    """A voice predicting the sine vibrato's streams: the postprocessed
    streams at ATOL and ``svs()`` at SNR_DB in both engines."""
    model_dir = _six_stream_pack(tmp_path)
    with traced_flax_inits():
        jax_engine = JaxSPSVS(model_dir)
    engine = SPSVS(model_dir, device="cpu")
    ref_dm = jax_engine.predict_timing(_short_labels(jax_hts))
    dm = engine.predict_timing(_short_labels(hts))
    assert list(dm.start_times) == list(ref_dm.start_times)
    acoustic = jax_engine.predict_acoustic(ref_dm)
    np.testing.assert_allclose(engine.predict_acoustic(dm), acoustic,
                               atol=ATOL)
    ref = jax_engine.postprocess_acoustic(acoustic, ref_dm)
    got = engine.postprocess_acoustic(acoustic, dm)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL)
    ref_wav, sr = jax_engine.svs(_short_labels(jax_hts), dtype=np.float32)
    wav, sr_port = engine.svs(_short_labels(hts), dtype=np.float32)
    assert sr == sr_port == SR and wav.shape == ref_wav.shape
    assert _snr(ref_wav, wav) > SNR_DB, _snr(ref_wav, wav)
