"""The slice: the mel voice served and trained on the port against the
JAX package, on the CPU.

The voice is ``chip_smoke.mel_phases(tiny=True)``: the shipped
``acoustic_melf0_ar_f0_diff_mel.yaml`` (the encoder-less
``MDNMultistreamSeparateF0MelModel``: the AR residual-F0 lf0 decoder at r
= 4, a DDPM mel decoder of K_step CHAIN_STEPS, the FFConvLSTM vuv
decoder) at tiny widths, ``timelag_mdn.yaml`` / ``duration_mdn.yaml``, the
mel postfilter ``postfilter_mel.yaml`` (``MelF0MultistreamPostFilter``)
and the recipe's hn-uSFGAN at ``aux_channels`` 80, narrowed; its random
weights (torch's seeded initial ones) packed by the JAX package's
``pack_model`` and opened by the JAX ``SPSVS`` and by the port's
``SPSVS(model_dir, device="cpu")``.  A twin pack swaps in a tiny PWG on
[mel, lf0, vuv].  The AR decoder's prenet dropout and the vuv decoder's
dropout are 0 (their masks cannot match jax.random's bits); every other
draw is the same on both sides (``tests/test_torch_mel_models.
same_draws``: the chains' x_T and steps, the postfilter's noise, PWG's).

``svs()`` under ``gv`` and ``nnsvs`` with ``usfgan`` and ``pwg``: the
streams each engine hands its vocoder at ATOL and the int16 waveform at
SNR_DB, as ``tests/test_torch_svs_diffusion.py`` holds the diffusion
voice; the WORLD vocoder refuses mel features on both.  Then one
single-track train step (``tests/test_torch_trainer.
assert_step_matches_jax``) of the mel cascade, of
``acoustic_diffusion_melf0.yaml`` and of ``acoustic_flowmatching_melf0.
yaml`` (tiny, ``chip_smoke.mel_only_config``) against JAX's
``train/loop.py`` step, with the diffusion draws and the FFT blocks'
dropout masks replayed (``tests/test_torch_mel_models.replayed_dropout``).
"""

import copy
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
from ensemble_svs_with_interactions_tpu.svs import SPSVS as JaxSPSVS
from ensemble_svs_with_interactions_tpu.utils.packing import (
    pack_model as jax_pack_model,
    save_model_phase as jax_save_model_phase,
)
from ensemble_svs_with_interactions_tpu.utils import scalers as jax_scalers
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.models import diffsinger
from ensemble_svs_with_interactions_tpu_torch.models.acoustic import (
    MDNMultistreamSeparateF0MelModel,
)
from ensemble_svs_with_interactions_tpu_torch.models.postfilters import (
    MelF0MultistreamPostFilter,
)
from ensemble_svs_with_interactions_tpu_torch.models.vocoders import usfgan
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    torch_to_flax,
)
from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
    MinMaxScaler,
)
from tests.test_torch_mel_models import (
    draw_ints,
    draw_normal,
    draw_uniform,
    replayed_dropout,
    same_draws,  # noqa: F401  (fixture)
)
from tests.test_torch_svs import _short_labels, traced_flax_inits
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)
from tests.test_torch_trainer import assert_step_matches_jax
from tests.util import HED

ATOL = 1e-4
SNR_DB = 40.0
CHAIN_STEPS = 4
SECONDS = 2.0
VOC = "ensemble_svs_with_interactions_tpu.models.vocoders"
# PWG on [mel, lf0, vuv], hop 240 at 48 kHz and 5 ms
PWG_CONFIG = {"netG": {
    "_target_": f"{VOC}.PWGGenerator", "layers": 4, "stacks": 2,
    "residual_channels": 4, "gate_channels": 8, "skip_channels": 4,
    "aux_channels": chip_smoke.MEL_DIMS + 2, "aux_context_window": 2,
    "upsample_scales": [4, 5, 6, 2]}}


def voice():
    glob, phases = chip_smoke.mel_phases(tiny=True, k_step=CHAIN_STEPS)
    net = phases["acoustic"][0]["netG"]
    net["lf0_model"]["prenet_dropout"] = 0.0
    net["vuv_model"]["dropout"] = 0.0
    return glob, phases


def _jax_scaler(sc):
    if sc is None:
        return None
    if isinstance(sc, MinMaxScaler):
        return jax_scalers.MinMaxScaler(sc.min_, sc.scale_)
    return jax_scalers.StandardScaler(sc.mean_, sc.var_, sc.scale_)


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """{"usfgan": the voice written by the JAX ``pack_model``, "pwg": the
    same with a PWG vocoder (its in-scaler seeded)}."""
    glob, phases = voice()
    weights = chip_smoke.random_state_dicts(phases, seed=0)
    parts = {}
    for name, (cfg, sc_in, sc_out) in phases.items():
        module = instantiate(cfg["netG"])
        module.load_state_dict(weights[name])
        parts[name] = {"model_config": cfg,
                       "variables": torch_to_flax(module),
                       "in_scaler": _jax_scaler(sc_in),
                       "out_scaler": _jax_scaler(sc_out)}
    dirs = {"usfgan": tmp_path_factory.mktemp("mel_usfgan")}
    jax_pack_model(dirs["usfgan"], glob, HED, parts)
    dirs["pwg"] = tmp_path_factory.mktemp("mel_pwg") / "pack"
    shutil.copytree(dirs["usfgan"], dirs["pwg"])
    for f in dirs["pwg"].glob("*vocoder*"):
        f.unlink()
    torch.manual_seed(1)
    pwg = instantiate(PWG_CONFIG["netG"])
    rng = np.random.default_rng(1)
    n = PWG_CONFIG["netG"]["aux_channels"]
    mean, scale = rng.normal(0, 0.1, n) - 2.5, rng.uniform(0.5, 2.0, n)
    mean[-2:], scale[-2:] = (np.log(260.0), 0.5), (0.24, 0.5)
    jax_save_model_phase(dirs["pwg"], "vocoder", PWG_CONFIG,
                         torch_to_flax(pwg),
                         in_scaler=jax_scalers.StandardScaler(
                             mean, scale ** 2, scale))
    return dirs


@pytest.fixture(scope="module")
def engines(packs):
    with traced_flax_inits():
        jax_engines = {k: JaxSPSVS(d) for k, d in packs.items()}
    return {k: (jax_engines[k], SPSVS(d, device="cpu"))
            for k, d in packs.items()}


@pytest.fixture
def port_pwg_noise(monkeypatch):
    """The port's PWG draws what JAX's draws under ``same_draws``."""
    monkeypatch.setattr(usfgan, "draw_noise",
                        lambda shape, generator: torch.from_numpy(
                            draw_normal(shape)).to(generator.device))


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2)
                         / max(np.sum((got - ref) ** 2), 1e-30))


def _svs_with_streams(engine, labels, **kw):
    """``engine.svs(labels, **kw)`` and the streams it handed its
    vocoder."""
    seen = []
    inner = engine.predict_waveform

    def record(streams, **k):
        seen.append(streams)
        return inner(streams, **k)

    engine.predict_waveform = record
    try:
        wav, sr = engine.svs(labels, **kw)
    finally:
        del engine.predict_waveform
    (streams,) = seen
    return wav, sr, streams


def test_mel_pack_loads_the_mel_modules(engines):
    """The port builds the mel cascade and the mel postfilter from the
    JAX-written pack; ``"auto"`` is the packed vocoder on both."""
    for kind, (jax_engine, engine) in engines.items():
        assert engine.feature_type == jax_engine.feature_type == "melf0"
        assert isinstance(engine.acoustic_model.module,
                          MDNMultistreamSeparateF0MelModel)
        assert isinstance(engine.postfilter_model.module,
                          MelF0MultistreamPostFilter)
        assert engine.default_vocoder_type == \
            jax_engine.default_vocoder_type == kind


@pytest.mark.parametrize("vocoder", ["usfgan", "pwg"])
@pytest.mark.parametrize("post_filter_type", ["gv", "nnsvs"])
def test_mel_svs_matches_jax(engines, same_draws,  # noqa: F811
                             port_pwg_noise, post_filter_type, vocoder):
    """Durations exactly, the (mel, lf0, vuv) streams at ATOL and the
    int16 waveform at SNR_DB."""
    jax_engine, engine = engines[vocoder]
    kw = {"vocoder_type": vocoder, "post_filter_type": post_filter_type}
    ref, sr_ref, ref_streams = _svs_with_streams(
        jax_engine, _short_labels(jax_hts, SECONDS), **kw)
    wav, sr, streams = _svs_with_streams(
        engine, _short_labels(hts, SECONDS), **kw)
    assert sr == sr_ref == 48000
    assert [s.shape[1] for s in streams] == [chip_smoke.MEL_DIMS, 1, 1]
    for g, r in zip(streams, ref_streams):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=ATOL)
    assert wav.dtype == ref.dtype == np.int16 and wav.shape == ref.shape
    assert np.abs(ref).max() > 0
    assert _snr(ref, wav) > SNR_DB, _snr(ref, wav)


def test_world_vocoder_refuses_mel_features(engines):
    """``vocoder_type="world"`` on mel streams raises JAX's ValueError on
    both engines."""
    streams = (np.zeros((40, chip_smoke.MEL_DIMS)), np.full((40, 1), 5.5),
               np.ones((40, 1)))
    for engine in engines["usfgan"]:
        with pytest.raises(ValueError,
                           match="invalid feature type for WORLD vocoder"):
            engine.predict_waveform(streams, vocoder_type="world")


# ------------------------------------------------------------ training
def mel_cascade_config():
    cfg = chip_smoke.mel_acoustic_config(tiny=True, k_step=CHAIN_STEPS)
    cfg["netG"]["lf0_model"]["prenet_dropout"] = 0.0
    cfg["netG"]["vuv_model"]["dropout"] = 0.0
    return cfg


STEP_CONFIGS = {
    "mel_cascade": mel_cascade_config,
    **{name: (lambda name=name: chip_smoke.mel_only_config(name, tiny=True))
       for name in chip_smoke.MEL_ONLY_CONFIGS},
}


def step_batch(cfg, B=3, T=24, seed=0):
    """Mixed lengths, targets around the streams' scale (a 0/1 vuv for
    the cascade), the pitch regularization's weights."""
    rng = np.random.default_rng(seed)
    D = sum(cfg["stream_sizes"])
    out = rng.normal(size=(B, T, D)).astype(np.float32)
    if D > chip_smoke.MEL_DIMS:
        out[..., -1] = rng.uniform(size=(B, T)) > 0.3
    return {"in_feats": rng.uniform(0, 1, (B, T, cfg["netG"]["in_dim"]))
            .astype(np.float32),
            "out_feats": out,
            "lengths": np.array([T, T - 5, T - 11], np.int32),
            "pitch_reg_dyn_ws": rng.uniform(0, 1, (B, T, 1)).astype(
                np.float32)}


@pytest.mark.parametrize("name", sorted(STEP_CONFIGS))
def test_mel_train_step_matches_jax(same_draws, monkeypatch,  # noqa: F811
                                    name):
    """The evaluation and one step (clipping off) from the port's
    flax-scheme weights: the metrics, every gradient; the DDPM's t and
    noise (the flow's t and x0) replayed into the port's evaluation and
    step, each run twice (float32, then the float64 oracle).  The
    cascade's lf0 residual is regularized (weight 1); the mel-only
    decoders predict none."""
    cfg = STEP_CONFIGS[name]()
    batch = step_batch(cfg)
    mel = cfg["netG"] if name != "mel_cascade" else \
        cfg["netG"]["mel_model"]
    shape = (3, 24, chip_smoke.MEL_DIMS)
    if "K_step" in mel:
        t = draw_ints(shape[:1], 0, mel["K_step"])
    else:
        t = draw_uniform(shape[:1])
    draws = [{"t": t, "noise": draw_normal(shape)}] * 4
    variables = torch_to_flax(init_module(instantiate(cfg["netG"])))
    with replayed_dropout(monkeypatch) as masks, \
            diffsinger.chain_noise(copy.deepcopy(draws)) as left:
        assert_step_matches_jax(
            cfg, {"pitch_reg_weight": float(name == "mel_cascade")}, batch,
            variables)
    assert not left
    # the FFT encoder's 1 + 4 dropouts a block (4 blocks narrowed to 2)
    assert len(masks) == (0 if name == "mel_cascade" else 1 + 4 * 2)
