"""Serving with a packed neural vocoder: the port's ``SPSVS`` against the
JAX engine on the CPU, at tiny widths, both opening the same packed
directories.

* The tiny single-track voice of tests/test_torch_svs_single.py with a
  tiny parallel hn-uSFGAN vocoder, packed twice: by the JAX package's
  ``pack_model`` plus its ``save_model_phase`` for the vocoder, and by the
  port's ``pack_model`` (the vocoder as a module of the port).  Both load
  in both engines, and ``vocoder_type="auto"`` is ``"usfgan"``.
* The same voice with a tiny PWG vocoder (JAX-written): ``"auto"`` is
  ``"pwg"``.  PWG's noise cannot match across frameworks by seed, so the
  port's ``usfgan.draw_noise`` is patched to JAX's draw.
* The tiny multitrack pack of tests/test_torch_svs.py with the hn-uSFGAN
  vocoder, for ``svs_ensemble`` and one pair through the per-pair API.

The uSFGAN excitation is host NumPy (seed 0) on both sides, so the whole
render is comparable: durations exactly, the vocoder stage on identical
streams at SNR >= 60 dB, whole renders at SNR >= 40 dB (acoustic features
differ at 1e-4 between the frameworks).  The AR decoder's prenet dropout
is 0 in these voices, as in the single-track tests.
"""

import jax
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
from ensemble_svs_with_interactions_tpu.svs import SPSVS as JaxSPSVS
from ensemble_svs_with_interactions_tpu.utils.packing import (
    pack_model as jax_pack_model,
    save_model_phase as jax_save_model_phase,
)
from ensemble_svs_with_interactions_tpu.utils.scalers import (
    MinMaxScaler as JaxMinMax,
    StandardScaler as JaxStandard,
)
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.models.vocoders import (
    USFGANWrapper,
    VocoderPack,
    usfgan,
)
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    torch_to_flax,
)
from ensemble_svs_with_interactions_tpu_torch.utils.packing import (
    pack_model,
)
from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
    MinMaxScaler,
    StandardScaler,
)
from tests import test_torch_svs as mt
from tests.test_torch_svs import _short_labels, tiny_phases
from tests.test_torch_svs_single import tiny_single_model
from tests.util import HED
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

VOC = "ensemble_svs_with_interactions_tpu.models.vocoders"
SR = 24000
AUX = 8 + 3       # the tiny voices' mgc + coded bap
SECONDS = 3.0
STAGE_SNR_DB = 60.0
SNR_DB = 40.0
SPKS = (2, 0)


def _net(blockA=0, cycleA=0, blockF=0, cycleF=0):
    return {"blockA": blockA, "cycleA": cycleA, "blockF": blockF,
            "cycleF": cycleF, "cascade_mode": 0}


# hop 120 at 24 kHz and 5 ms = 4 * 5 * 6
USFGAN_CONFIG = {
    "netG": {
        "_target_": f"{VOC}.ParallelHnUSFGANGenerator",
        "harmonic_network_params": _net(blockA=4, cycleA=2),
        "noise_network_params": _net(blockF=2, cycleF=2),
        "filter_network_params": _net(blockF=4, cycleF=2),
        "periodicity_estimator_params": {"conv_layers": 2, "kernel_size": 3,
                                         "dilation": 1},
        "residual_channels": 4, "gate_channels": 8, "skip_channels": 4,
        "aux_channels": AUX, "aux_context_window": 2,
        "upsample_params": {"upsample_scales": [4, 5, 6]},
    },
    "signal_types": ["sine", "noise"], "dense_factor": 4, "sine_amp": 0.1,
    "noise_amp": 0.003,
}
PWG_CONFIG = {
    "netG": {
        "_target_": f"{VOC}.PWGGenerator", "layers": 4, "stacks": 2,
        "residual_channels": 4, "gate_channels": 8, "skip_channels": 4,
        "aux_channels": AUX + 2, "aux_context_window": 2,
        "upsample_scales": [4, 5, 6],
    },
}


def _vocoder(cfg, seed):
    """(port module with seeded initial weights, in-scaler statistics)."""
    torch.manual_seed(seed)
    module = instantiate(cfg["netG"])
    rng = np.random.default_rng(seed)
    n = cfg["netG"]["aux_channels"]
    mean, scale = rng.normal(0, 1, n), rng.uniform(0.5, 2.0, n)
    return module, (mean, scale ** 2, scale)


def _jax_pack(model_dir, model, cfg, seed):
    """The voice by the JAX ``pack_model``, then its vocoder by the JAX
    ``save_model_phase`` (flax variables, a StandardScaler in-scaler)."""
    glob, cfgs, variables, stats = model
    jax_pack_model(model_dir, glob, HED, tiny_phases(
        cfgs, stats, JaxMinMax, JaxStandard,
        lambda ph: {"variables": variables[ph]}))
    module, sc = _vocoder(cfg, seed)
    jax_save_model_phase(model_dir, "vocoder", cfg, torch_to_flax(module),
                         in_scaler=JaxStandard(*sc))
    return model_dir


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{writer: directory} of the single-track voice with the hn-uSFGAN
    vocoder ("jax", "port"), with PWG ("pwg"), and the multitrack voice
    with hn-uSFGAN ("multitrack")."""
    single = tiny_single_model()
    out = {"jax": _jax_pack(tmp_path_factory.mktemp("voc_jax"), single,
                            USFGAN_CONFIG, 0),
           "pwg": _jax_pack(tmp_path_factory.mktemp("voc_pwg"), single,
                            PWG_CONFIG, 1),
           "multitrack": _jax_pack(tmp_path_factory.mktemp("voc_mt"),
                                   mt.tiny_model(), USFGAN_CONFIG, 0)}
    glob, cfgs, variables, stats = single
    phases = tiny_phases(cfgs, stats, MinMaxScaler, StandardScaler,
                         lambda ph: {"variables": variables[ph]})
    module, sc = _vocoder(USFGAN_CONFIG, 0)
    phases["vocoder"] = {"model_config": USFGAN_CONFIG, "module": module,
                         "in_scaler": StandardScaler(*sc)}
    out["port"] = pack_model(tmp_path_factory.mktemp("voc_port"), glob, HED,
                             phases)
    return out


@pytest.fixture(scope="module")
def engines(dirs):
    with mt.traced_flax_inits():
        jax_engines = {k: JaxSPSVS(d) for k, d in dirs.items()}
    return {k: (jax_engines[k], SPSVS(d, device="cpu"))
            for k, d in dirs.items()}


@pytest.fixture
def jax_pwg_noise(monkeypatch):
    """The port's PWG draws what JAX's ``PWGGenerator.inference`` draws."""
    def draw(shape, generator):
        noise = jax.random.normal(jax.random.PRNGKey(0), shape)
        return torch.from_numpy(np.array(noise)).to(generator.device)

    monkeypatch.setattr(usfgan, "draw_noise", draw)


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2)
                         / max(np.sum((got - ref) ** 2), 1e-30))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_packed_vocoder_loads_in_both_engines(dirs, engines, writer):
    """Each directory opens in both engines with the ``usfgan`` type and
    the same generator weights and in-scaler."""
    jax_engine, engine = engines[writer]
    assert jax_engine.default_vocoder_type == "usfgan"
    assert engine.default_vocoder_type == "usfgan"
    assert isinstance(engine.vocoder, USFGANWrapper)
    assert "vocoder='usfgan'" in repr(engine)
    ref_module, sc = _vocoder(USFGAN_CONFIG, 0)
    for name, value in ref_module.state_dict().items():
        torch.testing.assert_close(engine.vocoder.module.state_dict()[name],
                                   value, rtol=0, atol=0)
    for got, ref in zip((engine.vocoder_in_scaler.mean_,
                         engine.vocoder_in_scaler.scale_), (sc[0], sc[2])):
        np.testing.assert_array_equal(got, ref)
    assert engine.vocoder.signal_generator.signal_types == ["sine", "noise"]
    assert engine.vocoder.hop_size == 120


def test_pwg_pack_loads_with_the_pwg_type(engines):
    jax_engine, engine = engines["pwg"]
    assert jax_engine.default_vocoder_type == engine.default_vocoder_type \
        == "pwg"
    assert isinstance(engine.vocoder, VocoderPack)


@pytest.fixture(scope="module")
def streams(engines):
    """The port's host streams of the single-track voice on the short
    fixture (fed to both engines' vocoder stage)."""
    engine = engines["jax"][1]
    dm = engine.predict_timing(_short_labels(hts, SECONDS))
    return engine.postprocess_acoustic(engine.predict_acoustic(dm), dm)


@pytest.mark.parametrize("case", ["usfgan", "auto", "pwg", "pwg_auto"])
def test_vocoder_stage_matches_jax(engines, streams, jax_pwg_noise, case):
    """``predict_waveform`` on identical streams, at SNR >= 60 dB."""
    jax_engine, engine = engines["pwg" if "pwg" in case else "jax"]
    vocoder_type = "auto" if case.endswith("auto") else case
    ref = jax_engine.predict_waveform(streams, vocoder_type=vocoder_type)
    got = engine.predict_waveform(streams, vocoder_type=vocoder_type)
    assert got.shape == ref.shape == (len(streams[1]) * 120,)
    assert np.abs(ref).max() > 0
    assert _snr(ref, got) > STAGE_SNR_DB, _snr(ref, got)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_svs_auto_matches_jax(engines, writer):
    """``svs(vocoder_type="auto")`` end to end: durations exactly, the
    int16 waveform at SNR >= 40 dB, the vocoder in the stage times."""
    jax_engine, engine = engines[writer]
    ref_dm = jax_engine.predict_timing(_short_labels(jax_hts, SECONDS))
    dm = engine.predict_timing(_short_labels(hts, SECONDS))
    assert list(dm.start_times) == list(ref_dm.start_times)
    assert list(dm.end_times) == list(ref_dm.end_times)
    ref, sr_ref = jax_engine.svs(_short_labels(jax_hts, SECONDS),
                                 vocoder_type="auto")
    wav, sr = engine.svs(_short_labels(hts, SECONDS), vocoder_type="auto")
    assert sr == sr_ref == SR
    assert wav.dtype == ref.dtype == np.int16 and wav.shape == ref.shape
    assert _snr(ref, wav) > SNR_DB, _snr(ref, wav)
    assert engine.last_stage_times["vocoder"] > 0


def test_svs_ensemble_matches_jax(engines):
    """The multitrack voice's ``svs_ensemble`` with the packed vocoder:
    each track at SNR >= 40 dB (float32 output); ``"usfgan"`` renders as
    ``"auto"`` does."""
    jax_engine, engine = engines["multitrack"]
    secs = (SECONDS, 2.5, SECONDS)
    kw = {"spk_ids": [0, 1, 2], "dtype": np.float32}
    ref, _ = jax_engine.svs_ensemble(
        [_short_labels(jax_hts, s) for s in secs], "auto", **kw)
    got, sr = engine.svs_ensemble([_short_labels(hts, s) for s in secs],
                                  "auto", **kw)
    again, _ = engine.svs_ensemble([_short_labels(hts, s) for s in secs],
                                   "usfgan", **kw)
    assert sr == SR and len(got) == len(ref) == 3
    for g, r, a in zip(got, ref, again):
        assert g.dtype == r.dtype == np.float32 and g.shape == r.shape
        assert _snr(r, g) > SNR_DB, _snr(r, g)
        np.testing.assert_array_equal(a, g)
    assert engine.last_stage_times["vocoder"] > 0


def _pair(mod):
    main, sub = _short_labels(mod, SECONDS), _short_labels(mod, 2.5)
    sub.start_times = [sub.start_times[0]] + [t + 152500 for t in
                                              sub.start_times[1:]]
    sub.end_times = [t + 152500 for t in sub.end_times]
    return main, sub


def _render_pair(engine, main, sub):
    dm = engine.predict_timing_multitrack([main, sub], list(SPKS))[0]
    dm_sub = engine.predict_timing_multitrack([sub, main],
                                              list(SPKS)[::-1])[0]
    acoustic = engine.predict_acoustic_multitrack([dm, dm_sub], list(SPKS))
    streams = engine.postprocess_acoustic(acoustic, dm)
    wav = engine.predict_waveform(streams, vocoder_type="auto")
    return dm, engine.postprocess_waveform(wav, dtype=np.float64)


def test_pair_matches_jax(engines):
    """One pair through the per-pair API with the packed vocoder, as
    ``bin/synthesis_multitrack.py`` renders it: the main track's
    durations exactly, the waveform at SNR >= 40 dB."""
    jax_engine, engine = engines["multitrack"]
    ref_dm, ref = _render_pair(jax_engine, *_pair(jax_hts))
    dm, got = _render_pair(engine, *_pair(hts))
    assert list(dm.end_times) == list(ref_dm.end_times)
    assert got.shape == ref.shape
    assert _snr(ref, got) > SNR_DB, _snr(ref, got)


def test_from_parts_vocoder_renders_as_the_pack(dirs, engines, streams):
    """``SPSVS.from_parts`` with a ``"vocoder"`` phase (a state dict) builds
    the loaded engine's vocoder: the same waveform bitwise."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        load_config,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
        load_minmax_scaler,
        load_standard_scaler,
    )

    engine = engines["port"][1]
    d = dirs["port"]
    phases = {}
    for ph in ("timelag", "duration", "acoustic"):
        pack = getattr(engine, f"{ph}_model")
        phases[ph] = {"model_config": load_config(d / f"{ph}_model.yaml"),
                      "state_dict": pack.module.state_dict(),
                      "in_scaler": load_minmax_scaler(d / f"in_{ph}_scaler"),
                      "out_scaler": load_standard_scaler(
                          d / f"out_{ph}_scaler")}
    module, sc = _vocoder(USFGAN_CONFIG, 0)
    phases["vocoder"] = {"model_config": USFGAN_CONFIG,
                         "state_dict": module.state_dict(),
                         "in_scaler": StandardScaler(*sc)}
    built = SPSVS.from_parts(load_config(d / "config.yaml"), HED, phases,
                             device="cpu")
    assert built.default_vocoder_type == "usfgan"
    np.testing.assert_array_equal(
        built.predict_waveform(streams, vocoder_type="auto"),
        engine.predict_waveform(streams, vocoder_type="usfgan"))
    assert built.set_device("cpu").vocoder.device == torch.device("cpu")
