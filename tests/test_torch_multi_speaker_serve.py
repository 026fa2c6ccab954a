"""Serving a multi-speaker voice on the port against the JAX package, on
the CPU: a pack of the narrowed shipped
``multi_speaker_acoustic_multistream_ar_f0.yaml`` with the stock timing
models, written by the JAX package's ``pack_model`` and opened by both
engines, through ``gen.predict_acoustic(spk=k)`` (``k`` an int, a (1,)
array or a (1, 1) array, as JAX's ``ModelPack`` takes each), then
``gen.postprocess_acoustic`` and the WORLD vocoder, on the first seconds
of the fixture.

Durations exactly; acoustic features and streams at ATOL (float32 on both
sides with other summation orders, the GV postfilter on random weights);
the waveform by SNR >= 40 dB (the bound of ``tests/test_torch_world.py``)
against JAX's vocoder on JAX's streams with the port's noise.  The AR
decoder's prenet dropout cannot reproduce jax.random's bits, so
``prenet_dropout = 0``.  The multitrack path keeps its per-track speaker
tuple.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ensemble_svs_with_interactions_tpu import gen as jax_gen
from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
from ensemble_svs_with_interactions_tpu.ops.world import (
    synthesis as jax_syn,
)
from ensemble_svs_with_interactions_tpu.ops.world.codec import (
    get_cheaptrick_fft_size,
)
from ensemble_svs_with_interactions_tpu.svs import SPSVS as JaxSPSVS
from ensemble_svs_with_interactions_tpu.utils.packing import (
    pack_model as jax_pack_model,
)
from ensemble_svs_with_interactions_tpu_torch import gen
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    torch_to_flax,
)
from tests.test_torch_mel_voice import _jax_scaler, _snr
from tests.test_torch_svs import _short_labels, traced_flax_inits
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)
from tests.util import HED

ATOL = 1e-4
SNR_DB = 40.0
SECONDS = 2.5
# the speaker ids as JAX's ModelPack.inference takes them, one id each
SPK_FORMS = {"int": 1, "array": np.array([2]), "column": np.array([[0]])}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine) over one directory written by the JAX
    ``pack_model`` from the port's flax-scheme weights (the speaker table
    drawn at std 0.5, so the speakers part clearly)."""
    glob, phases = chip_smoke.multi_speaker_phases(tiny=True)
    net = phases["acoustic"][0]["netG"]
    net["lf0_model"]["prenet_dropout"] = 0.0
    net["speaker_embedding"]["std"] = 0.5
    parts = {}
    for seed, (name, (cfg, sc_in, sc_out)) in enumerate(phases.items()):
        module = init_module(instantiate(cfg["netG"]), seed=seed)
        parts[name] = {"model_config": cfg,
                       "variables": torch_to_flax(module),
                       "in_scaler": _jax_scaler(sc_in),
                       "out_scaler": _jax_scaler(sc_out)}
    model_dir = tmp_path_factory.mktemp("multi_speaker")
    jax_pack_model(model_dir, glob, HED, parts)
    with traced_flax_inits():
        jax_engine = JaxSPSVS(model_dir)
    return jax_engine, SPSVS(model_dir, device="cpu")


@pytest.fixture(scope="module")
def timed(engines):
    jax_engine, engine = engines
    ref = jax_engine.predict_timing(_short_labels(jax_hts, SECONDS))
    got = engine.predict_timing(_short_labels(hts, SECONDS))
    assert list(got.start_times) == list(ref.start_times)
    assert list(got.end_times) == list(ref.end_times)
    return ref, got


@pytest.fixture(scope="module")
def rendered(engines, timed):
    """{form: (JAX features, port features)} for each speaker form."""
    (jax_engine, engine), (ref_dm, dm) = engines, timed
    return {form: (chip_smoke.speaker_acoustic(jax_gen, jax_engine, ref_dm,
                                               spk),
                   chip_smoke.speaker_acoustic(gen, engine, dm, spk))
            for form, spk in SPK_FORMS.items()}


@pytest.mark.parametrize("form", sorted(SPK_FORMS))
def test_predict_acoustic_with_a_speaker_matches_jax(engines, timed,
                                                     rendered, form):
    """The features, the postprocessed streams and the WORLD waveform of
    one speaker, its id given in each of the forms JAX serves."""
    (jax_engine, engine), (ref_dm, dm) = engines, timed
    ref, got = rendered[form]
    assert got.shape == ref.shape and got.shape[1] == 67
    np.testing.assert_allclose(got, ref, atol=ATOL)
    ref_streams = jax_engine.postprocess_acoustic(ref, ref_dm)
    streams = engine.postprocess_acoustic(got, dm)
    for g, r in zip(streams, ref_streams):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=ATOL)
    wav = engine.predict_waveform(streams, vocoder_type="world")
    T = len(streams[1])
    T_pad = gen._round_up(T, gen.FRAME_BUCKET)
    sr, hop = engine.sample_rate, engine.sample_rate * 5 // 1000
    noise = gen.vocoder_noise(1, T_pad * hop, "cpu").numpy()
    padded = [a[None] for a in gen.pad_streams(ref_streams, T_pad)]
    want = np.asarray(jax_syn._synthesize_from_streams_impl(
        *(jnp.asarray(a) for a in (*padded, noise)), sr, hop,
        get_cheaptrick_fft_size(sr), 0.5, 0.0))[0, : T * hop]
    assert wav.shape == want.shape == (T * hop,)
    assert _snr(want, wav) > SNR_DB, _snr(want, wav)


def test_speakers_part(rendered):
    """Each speaker renders its own features."""
    feats = [got for _, got in rendered.values()]
    for a in feats:
        for b in feats:
            if a is not b:
                assert np.abs(a - b).max() > 1e-3


class _Spy(torch.nn.Module):
    """A stand-in module that records the speaker argument it is given."""

    def __init__(self, out_dim=3):
        super().__init__()
        self.seen, self.out_dim = [], out_dim

    def prediction_type(self):
        from ensemble_svs_with_interactions_tpu_torch.base import (
            PredictionType,
        )

        return PredictionType.DETERMINISTIC

    def inference(self, x, spks, lengths=None):
        self.seen.append(spks)
        return torch.zeros(x.shape[0], x.shape[1], self.out_dim)


@pytest.mark.parametrize("spk,kind,shape", [
    (1, torch.Tensor, ()), (np.array([2]), torch.Tensor, (1,)),
    (np.array([[0]]), torch.Tensor, (1, 1)),
    (([0], [2]), tuple, None),
])
def test_model_pack_hands_speakers_as_given(spk, kind, shape):
    """A single-track model gets its ids as one tensor of the caller's
    shape; the multitrack form (a tuple, one id sequence a track) stays a
    tuple of tensors."""
    spy = _Spy()
    pack = gen.ModelPack(spy, {"stream_sizes": [3]}, device="cpu")
    out = pack.inference(np.zeros((5, 4), np.float32), spks=spk)
    assert out.shape == (5, 3)
    (seen,) = spy.seen
    assert isinstance(seen, kind)
    if shape is None:
        assert [tuple(s.tolist()) for s in seen] == [(0,), (2,)]
    else:
        assert tuple(seen.shape) == shape and seen.dtype == torch.int64
        assert seen.flatten().tolist() == np.ravel(spk).tolist()


def test_svs_ensemble_keeps_the_per_track_speaker_tuple():
    """The tiny flagship's ``svs_ensemble`` hands its timing models and its
    acoustic model (``inference_main``) the (main, sub) speaker tuple."""
    glob, phases = chip_smoke.flagship_phases(tiny=True)
    weights = chip_smoke.random_state_dicts(phases, seed=0)
    engine = SPSVS.from_parts(glob, HED, {
        name: {"model_config": cfg, "state_dict": weights[name],
               "in_scaler": sc_in, "out_scaler": sc_out}
        for name, (cfg, sc_in, sc_out) in phases.items()}, device="cpu")
    seen = []
    for pack in (engine.timelag_model, engine.acoustic_model):
        inner = pack.inference_batch

        def record(xs, spks=None, *a, _inner=inner, **kw):
            seen.append(spks)
            return _inner(xs, spks, *a, **kw)

        pack.inference_batch = record
    labels = [_short_labels(hts, 1.0) for _ in range(2)]
    wavs = engine.svs_ensemble(labels, spk_ids=[0, 1])
    assert len(wavs) == 2 and len(seen) >= 2
    for spks in seen:
        assert isinstance(spks, tuple) and len(spks) == 2
