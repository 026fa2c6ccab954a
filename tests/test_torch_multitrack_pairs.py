"""The port's per-pair multitrack API, the one the recipe's synthesis stage
(``bin/synthesis_multitrack.py``) calls, against the JAX package, on the
tiny multitrack pack of tests/test_torch_svs.py (the same configs and
scalers; the weights are the port's modules' seeded initial ones, carried
to flax by ``torch_to_flax``), written by the JAX package's
``pack_model`` and opened by both ``SPSVS``.

One pair is a main track and a sub track 15.25 ms late and shorter:
timelag, durations and timing each way, the main track's acoustic
features (``inference_main`` at B = 1), and a whole
``svs_multitrack``-style render.  Durations exactly; lags, MDN durations
and normalized durations at TIMING_RTOL (float32 on both sides); acoustic
features at ATOL; the waveform at SNR >= 40 dB with the port's vocoder
noise fed to the JAX vocoder (``jax.random.normal`` patched), the bound of
tests/test_torch_world.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu import gen_multitrack as jax_gmt
from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
from ensemble_svs_with_interactions_tpu.svs import SPSVS as JaxSPSVS
from ensemble_svs_with_interactions_tpu.utils.packing import pack_model
from ensemble_svs_with_interactions_tpu.utils.scalers import (
    MinMaxScaler as JaxMinMax,
    StandardScaler as JaxStandard,
)
from ensemble_svs_with_interactions_tpu_torch import gen
from ensemble_svs_with_interactions_tpu_torch import gen_multitrack as gmt
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    torch_to_flax,
)
from tests.test_torch_svs import N_SPK, SR, _configs, _short_labels
from tests.test_torch_svs import tiny_phases, traced_flax_inits
from tests.util import HED
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

ATOL = 1e-4
TIMING_RTOL = 1e-5
SNR_DB = 40.0
SPKS = (2, 0)
SUB_LAG = 152500  # 3.05 frames of 5 ms, in 100 ns units


def _pair(mod):
    """(main, sub): the fixture's first 4 s, and its first 3 s sung
    SUB_LAG late, off the frame grid, which rounding moves onto it."""
    main = _short_labels(mod, 4.0)
    sub = _short_labels(mod, 3.0)
    sub.start_times = [sub.start_times[0]] + [
        t + SUB_LAG for t in sub.start_times[1:]]
    sub.end_times = [t + SUB_LAG for t in sub.end_times]
    return main, sub


def _times(labels):
    return list(labels.start_times), list(labels.end_times)


@pytest.fixture(autouse=True)
def port_vocoder_noise(monkeypatch):
    """The JAX vocoder draws the port's ``vocoder_noise``."""
    def normal(key, shape, dtype=jnp.float32):
        n = gen.vocoder_noise(1, int(np.prod(shape)), "cpu").numpy()
        return jnp.asarray(n.reshape(shape), dtype)

    monkeypatch.setattr(jax.random, "normal", normal)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    timelag, duration, acoustic, ss = _configs()
    cfgs = {"timelag": timelag, "duration": duration, "acoustic": acoustic}
    variables = {}
    for k, (name, cfg) in enumerate(sorted(cfgs.items())):
        torch.manual_seed(k)
        variables[name] = torch_to_flax(instantiate(cfg["netG"]))
    mean = np.zeros(sum(ss))
    scale = np.ones(sum(ss)) * 0.1
    mean[ss[0]] = np.log(220.0)
    stats = {"timelag": (82, np.zeros(3), np.ones(3) * 2),
             "duration": (82, np.ones(1) * 10, np.ones(1) * 2),
             "acoustic": (86, mean, scale)}
    glob = {"sample_rate": SR, "frame_period": 5, "feature_type": "world",
            "use_world_codec": True, "relative_f0": False,
            "spk_list": [f"spk{i}" for i in range(N_SPK)]}
    model_dir = tmp_path_factory.mktemp("packed_pairs")
    pack_model(model_dir, glob, HED, tiny_phases(
        cfgs, stats, JaxMinMax, JaxStandard,
        lambda ph: {"variables": variables[ph]}))
    with traced_flax_inits():
        jax_engine = JaxSPSVS(model_dir)
    return jax_engine, SPSVS(model_dir, device="cpu")


def _models(engine, phase):
    return (getattr(engine, f"{phase}_model"),
            getattr(engine, f"in_{phase}_scaler"),
            getattr(engine, f"out_{phase}_scaler"),
            engine.binary_dict, engine.numeric_dict)


@pytest.mark.parametrize("direction", ["main_sub", "sub_main"])
def test_predict_timelag_and_duration_multitrack_match_jax(engines,
                                                           direction):
    """The timelag (MLPG over the merged timeline, then clipped) and the
    MDN durations of the main track, and its mask on the merged
    timeline."""
    jax_engine, engine = engines
    order = slice(None) if direction == "main_sub" else slice(None, None, -1)
    spks = list(SPKS)[order]
    ref_labels, labels = list(_pair(jax_hts))[order], list(_pair(hts))[order]
    ref = jax_gmt.predict_timelag_multitrack(
        ref_labels, spks, *_models(jax_engine, "timelag"), frame_period=5)
    got = gmt.predict_timelag_multitrack(
        labels, spks, *_models(engine, "timelag"), frame_period=5)
    for lab, ref_lab in zip(labels, ref_labels):
        assert _times(lab) == _times(ref_lab)  # both rounded in place
    np.testing.assert_allclose(got[1], ref[1], rtol=TIMING_RTOL)
    np.testing.assert_allclose(got[0], ref[0], rtol=TIMING_RTOL)
    np.testing.assert_array_equal(got[2], ref[2])
    assert not got[2].all()  # the sub track's notes are merged in
    ref = jax_gmt.predict_duration_multitrack(
        ref_labels, spks, *_models(jax_engine, "duration"), frame_period=5)
    got = gmt.predict_duration_multitrack(
        labels, spks, *_models(engine, "duration"), frame_period=5)
    assert len(got[0]) == len(labels[0])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=TIMING_RTOL)


@pytest.fixture(scope="module")
def timed(engines):
    """Both engines' ``predict_timing_multitrack`` of the pair, each way:
    {direction: (JAX's 4-tuple, the port's)}."""
    jax_engine, engine = engines
    out = {}
    for name, order in (("main", slice(None)), ("sub", slice(None, None, -1))):
        spks = list(SPKS)[order]
        out[name] = (
            jax_engine.predict_timing_multitrack(list(_pair(jax_hts))[order],
                                                 spks),
            engine.predict_timing_multitrack(list(_pair(hts))[order], spks))
    return out


@pytest.mark.parametrize("direction", ["main", "sub"])
def test_predict_timing_multitrack_matches_jax(timed, direction):
    """The JAX 4-tuple: duration-modified labels exactly, lag and
    cumulative normalized durations at TIMING_RTOL, the mask exactly."""
    ref, got = timed[direction]
    assert len(got) == len(ref) == 4
    assert _times(got[0]) == _times(ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=TIMING_RTOL)
    np.testing.assert_allclose(got[2], ref[2], rtol=TIMING_RTOL)
    np.testing.assert_array_equal(got[3], ref[3])


def test_predict_timing_multitrack_leaves_the_callers_labels(engines):
    """The engine copies the labels the timelag model rounds in place (as
    ``gen_multitrack.predict_timelag_multitrack`` does to what it is
    given)."""
    _, engine = engines
    labels = list(_pair(hts))
    before = [(_times(lab), lab.frame_shift) for lab in labels]
    engine.predict_timing_multitrack(labels, list(SPKS))
    assert [(_times(lab), lab.frame_shift) for lab in labels] == before
    gmt.predict_timelag_multitrack(labels, list(SPKS),
                                   *_models(engine, "timelag"))
    assert [_times(lab) for lab in labels] != [b[0] for b in before]


def test_predict_acoustic_multitrack_matches_jax(engines, timed):
    """The main track's acoustic features from ``inference_main`` at B = 1,
    both tracks padded to the longer, at ATOL."""
    jax_engine, engine = engines
    ref = jax_engine.predict_acoustic_multitrack(
        [timed["main"][0][0], timed["sub"][0][0]], list(SPKS))
    got = engine.predict_acoustic_multitrack(
        [timed["main"][1][0], timed["sub"][1][0]], list(SPKS))
    assert got.shape == ref.shape and got.shape[1] == 13
    np.testing.assert_allclose(got, ref, atol=ATOL)


def _svs_multitrack(engine, main, sub):
    """``bin/synthesis_multitrack.py``'s ``svs_multitrack``: timing each
    way, the main track's acoustic features, the host postprocess, WORLD
    and the waveform's postprocess (float64)."""
    dm = engine.predict_timing_multitrack([main, sub], list(SPKS))[0]
    dm_sub = engine.predict_timing_multitrack([sub, main],
                                              list(SPKS)[::-1])[0]
    acoustic = engine.predict_acoustic_multitrack([dm, dm_sub], list(SPKS))
    streams = engine.postprocess_acoustic(acoustic, dm)
    wav = engine.predict_waveform(streams, vocoder_type="world")
    return engine.postprocess_waveform(wav, dtype=np.float64), streams


def _snr(ref, got):
    err = got - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-30))


def test_svs_multitrack_pair_matches_jax(engines):
    """One whole pair: the streams at ATOL, the waveform at SNR >= 40 dB;
    the port's stays as it was after ``set_device("cpu")``."""
    jax_engine, engine = engines
    ref, ref_streams = _svs_multitrack(jax_engine, *_pair(jax_hts))
    got, streams = _svs_multitrack(engine, *_pair(hts))
    for g, r in zip(streams, ref_streams):
        np.testing.assert_allclose(g, r, atol=ATOL)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float64
    assert _snr(ref, got) > SNR_DB, _snr(ref, got)
    assert engine.set_device("cpu") is engine
    again, _ = _svs_multitrack(engine, *_pair(hts))
    np.testing.assert_array_equal(again, got)


def test_set_device_moves_every_model(engines):
    """``set_device`` moves each model pack and the engine's device; a
    card that is not there raises, as ``SPSVS(device="cuda")`` does."""
    _, engine = engines
    engine.set_device(torch.device("cpu"))
    assert engine.device == torch.device("cpu")
    for pack in (engine.timelag_model, engine.duration_model,
                 engine.acoustic_model):
        assert pack.device == torch.device("cpu")
        assert all(p.device.type == "cpu" for p in pack.module.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.set_device("cuda")
        assert engine.device == torch.device("cpu")
