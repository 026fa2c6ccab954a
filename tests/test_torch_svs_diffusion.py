"""The slice: the recipe's diffusion ensemble voice served through the
normal entry points, the port's against the JAX package's, on the CPU.

The voice is ``chip_smoke.diffusion_phases(tiny=True)``: the shipped
``multitrack_acoustic_npss_diff_mgcbap.yaml`` at tiny widths (both
chains CHAIN_STEPS long, the AR lf0 decoder's prenet dropout 0, whose
masks cannot match jax.random's bits) with the flagship's multitrack
timing models, for its 3 singers.  Its random weights (torch's initial
ones, seeded; ``output_proj`` random) are packed by the port's
``pack_model`` and opened by the JAX ``SPSVS`` and by the port's
``SPSVS(model_dir, device="cpu")``.

Four parts of the shortened fixture, speakers (0, 1, 2, 0) in a ring, with
the JAX chains' noise replayed into the port
(``tests/test_torch_diffusion.jax_chains``): durations exactly, the
acoustic output and the device-postprocessed streams at 1e-4, and each
``svs_ensemble`` waveform at SNR >= 40 dB with the port's vocoder noise
fed to the JAX vocoder (``jax.random.normal`` patched for the vocoder's
shapes only; the chains' three-dimensional draws keep their own), through
the device postprocess and through the host one (merlin).  One
pair through ``predict_acoustic_multitrack`` at 1e-4; the ``_subtrack``
config serves the same audio; a pack naming an unported module of
``models/diffsinger.py`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from ensemble_svs_with_interactions_tpu import gen_multitrack as jax_gmt
from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
from ensemble_svs_with_interactions_tpu.svs import SPSVS as JaxSPSVS
from ensemble_svs_with_interactions_tpu_torch import gen
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.models import diffsinger
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
from tests.test_torch_diffusion import jax_chains
from tests.test_torch_svs import _short_labels, traced_flax_inits
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

ATOL = 1e-4
SNR_DB = 40.0
SR = 24000
CHAIN_STEPS = 6
N = 4
SPK_IDS = [0, 1, 2, 0]
PAIRS = [(i + 1) % N for i in range(N)]
_NORMAL = jax.random.normal


@pytest.fixture(autouse=True)
def port_vocoder_noise(monkeypatch):
    """The JAX vocoder (draws of one or two dimensions) draws the port's
    ``vocoder_noise``, in one chunk of all tracks as the port draws it
    (``ESVS_VOCODER_CHUNKS``); the chains' (B, T, M) draws stay JAX's
    own."""
    monkeypatch.setenv("ESVS_VOCODER_CHUNKS", str(N))

    def normal(key, shape=(), dtype=jnp.float32):
        if len(shape) > 2:
            return _NORMAL(key, shape, dtype)
        n = gen.vocoder_noise(1, int(np.prod(shape)), "cpu").numpy()
        return jnp.asarray(n.reshape(shape), dtype)

    monkeypatch.setattr(jax.random, "normal", normal)


def voice(subtrack=False):
    glob, phases = chip_smoke.diffusion_phases(tiny=True, subtrack=subtrack,
                                               k_step=CHAIN_STEPS)
    phases["acoustic"][0]["netG"]["lf0_model"]["prenet_dropout"] = 0.0
    glob["sample_rate"] = SR
    return glob, phases


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """{"": the voice's directory, "_subtrack": its twin's}, the same
    weights in both."""
    glob, phases = voice()
    weights = chip_smoke.random_state_dicts(phases, seed=0)
    dirs = {}
    for suffix in ("", "_subtrack"):
        glob, phases = voice(subtrack=bool(suffix))
        dirs[suffix] = tmp_path_factory.mktemp(f"diffusion{suffix}")
        chip_smoke.pack_phases(dirs[suffix], glob, phases, weights)
    return dirs


@pytest.fixture(scope="module")
def engines(packed):
    with traced_flax_inits():
        jax_engine = JaxSPSVS(packed[""])
    return jax_engine, SPSVS(packed[""], device="cpu")


def _labels(mod):
    return [_short_labels(mod) for _ in range(N)]


def _snr(ref, got):
    err = got.astype(np.float64) - ref
    return 10 * np.log10(np.sum(ref.astype(np.float64) ** 2)
                         / max(np.sum(err ** 2), 1e-30))


def test_svs_ensemble_slice_matches_jax(engines):
    """Durations exactly; the acoustic model's output (``inference_main``
    over the 4 pairs as one batch, both chains replayed) and the device
    postprocess at ATOL; the rendered int16 parts at SNR_DB."""
    jax_engine, engine = engines
    ref_dm = jax_gmt.predict_timing_multitrack_batch(
        _labels(jax_hts), SPK_IDS, PAIRS, jax_engine.binary_dict,
        jax_engine.numeric_dict, jax_engine.timelag_model,
        jax_engine.in_timelag_scaler, jax_engine.out_timelag_scaler,
        jax_engine.duration_model, jax_engine.in_duration_scaler,
        jax_engine.out_duration_scaler, frame_period=jax_engine.frame_period)
    got_dm = engine.predict_timing_multitrack_batch(_labels(hts), SPK_IDS,
                                                    PAIRS)
    for r, g in zip(ref_dm, got_dm):
        assert list(g.start_times) == list(r.start_times)
        assert list(g.end_times) == list(r.end_times)

    ref_feats, ref_raw = jax_engine._frame_features(ref_dm)
    feats, raw = engine._frame_features(got_dm)
    spks = (SPK_IDS, [SPK_IDS[p] for p in PAIRS])
    with jax_chains() as draws:
        ref_out, lengths = jax_engine.acoustic_model.inference_batch(
            ref_feats, spks=tuple(jnp.asarray(s, jnp.int32) for s in spks),
            sub_index=PAIRS, method="inference_main", device_out=True)
        ref_out = np.asarray(ref_out)
    assert [d["x_T"].shape[::2] for d in draws] == [(N, 60), (N, 5)]
    assert draws[0]["steps"].shape[0] == CHAIN_STEPS
    with diffsinger.chain_noise(draws):
        out, got_lengths = engine.acoustic_model.inference_batch(
            feats, spks=spks, sub_index=PAIRS, method="inference_main",
            device_out=True)
    np.testing.assert_array_equal(got_lengths, lengths)
    valid = np.arange(out.shape[1])[None, :] < np.asarray(lengths)[:, None]
    assert np.abs(ref_out[valid]).max() > 0.5
    np.testing.assert_allclose(out.numpy()[valid], ref_out[valid], atol=ATOL)

    ref_streams = jax_engine._fused_postprocess(ref_out, lengths, ref_raw,
                                                "gv")
    streams = engine._fused_postprocess(out, lengths, raw, "gv")
    for r, g in zip(ref_streams, streams):
        r, g = np.asarray(r), g.numpy()
        for i in range(N):
            np.testing.assert_allclose(g[i, : lengths[i]],
                                       r[i, : lengths[i]], atol=ATOL)

    with jax_chains() as draws:
        ref_wavs, sr = jax_engine.svs_ensemble(_labels(jax_hts),
                                               spk_ids=SPK_IDS)
    with diffsinger.chain_noise(draws):
        wavs, got_sr = engine.svs_ensemble(_labels(hts), spk_ids=SPK_IDS)
    assert sr == got_sr == SR and len(wavs) == len(ref_wavs) == N
    for r, g, n in zip(ref_wavs, wavs, lengths):
        assert g.dtype == r.dtype == np.int16
        assert len(g) == len(r) == n * SR * 5 // 1000
        assert np.abs(g.astype(np.int64)).max() > 0
        assert _snr(r, g) > SNR_DB, _snr(r, g)


def test_svs_ensemble_host_postprocess_matches_jax(engines):
    """``post_filter_type="merlin"`` takes the host postprocess, where the
    cascade's ``MULTISTREAM_HYBRID`` output is denormalized as a
    probabilistic one (static streams: its mean); each part at SNR_DB
    with the JAX chains replayed."""
    jax_engine, engine = engines
    assert not engine._fused_post_ok("merlin", [1000] * N)
    with jax_chains() as draws:
        ref_wavs, _ = jax_engine.svs_ensemble(
            _labels(jax_hts), post_filter_type="merlin", spk_ids=SPK_IDS)
    with diffsinger.chain_noise(draws):
        wavs, _ = engine.svs_ensemble(_labels(hts), post_filter_type="merlin",
                                      spk_ids=SPK_IDS)
    for r, g in zip(ref_wavs, wavs):
        assert g.dtype == r.dtype == np.int16 and len(g) == len(r)
        assert np.abs(g.astype(np.int64)).max() > 0
        assert _snr(r, g) > SNR_DB, _snr(r, g)


def test_predict_acoustic_multitrack_matches_jax(engines):
    """One pair through the per-pair API: timing each way exactly, the
    main track's acoustic features (``inference_main`` at B = 1) at
    ATOL."""
    jax_engine, engine = engines
    spks = [2, 0]
    timed = {}
    for name, e, mod in (("jax", jax_engine, jax_hts), ("port", engine, hts)):
        main, sub = _short_labels(mod, 4.0), _short_labels(mod, 3.0)
        timed[name] = (e.predict_timing_multitrack([main, sub], spks)[0],
                       e.predict_timing_multitrack([sub, main],
                                                   spks[::-1])[0])
    for r, g in zip(timed["jax"], timed["port"]):
        assert list(g.start_times) == list(r.start_times)
        assert list(g.end_times) == list(r.end_times)
    with jax_chains() as draws:
        ref = jax_engine.predict_acoustic_multitrack(list(timed["jax"]), spks)
    assert len(draws) == 2 and draws[0]["x_T"].shape[0] == 1
    with diffsinger.chain_noise(draws):
        got = engine.predict_acoustic_multitrack(list(timed["port"]), spks)
    assert got.shape == ref.shape and got.shape[1] == 67
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_subtrack_config_serves_the_same_audio(engines, packed):
    """The ``_subtrack`` twin (``output_subtrack: true``, which only
    training reads) renders the same int16 audio, bitwise; each call draws
    its chains afresh from a generator seeded alike, so two calls agree."""
    _, engine = engines
    twin = SPSVS(packed["_subtrack"], device="cpu")
    assert twin.acoustic_model.module.output_subtrack
    wavs = [e.svs_ensemble(_labels(hts), spk_ids=SPK_IDS)[0]
            for e in (engine, twin, engine)]
    for a, b, c in zip(*wavs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("name,where", [
    ("MultiSpeakerGaussianDiffusion", "mgc_model"),
    ("FFTBlocksEncoder", "mgc_model.encoder"),
    ("PitchPredictor", "vuv_model"),
    ("PitchExtractor", "vuv_model")])
def test_pack_naming_an_unported_diffsinger_module_raises(packed, tmp_path,
                                                          name, where):
    """``SPSVS(model_dir)`` refuses a pack whose acoustic model names a
    module of ``models/diffsinger.py`` that the port has not ported
    (``gen.UNPORTED``), naming it; one it has ported is built (from its
    defaults), and the pack's weights, which are another module's, fail
    the loader's check."""
    import shutil

    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        load_config,
        save_config,
    )

    shutil.copytree(packed[""], tmp_path / "pack")
    path = tmp_path / "pack" / "acoustic_model.yaml"
    cfg = load_config(path)
    node = cfg["netG"]
    for key in where.split("."):
        node = node[key]
    node["_target_"] = (
        f"ensemble_svs_with_interactions_tpu.models.diffsinger.{name}")
    if name not in gen.UNPORTED:
        # the ported module from its own defaults (the pack's own values
        # of the fields it has none for, in both packages)
        required = {"MultiSpeakerGaussianDiffusion": {"out_dim",
                                                      "denoise_fn"}}
        for key in set(node) - {"_target_", "in_dim",
                                *required.get(name, ())}:
            del node[key]
    save_config(cfg, path)
    if name not in gen.UNPORTED:
        with pytest.raises(ValueError, match="unmatched|torch .* vs flax"):
            SPSVS(tmp_path / "pack", device="cpu")
        return
    with pytest.raises(NotImplementedError,
                       match=f"models/diffsinger.py \\({name}\\)"):
        SPSVS(tmp_path / "pack", device="cpu")
