"""The mel voices' features on the port (``data/data_source.py``:
``logmelfilterbank`` and ``MelF0AcousticSource``) against the JAX
package's, on the CPU.

``logmelfilterbank`` is the same SciPy STFT and NumPy product on both
sides, so it is held bitwise, under the source's defaults and under other
window, hop, band and mel-count settings.  ``MelF0AcousticSource`` runs on
two songs of ``tests/util.build_synthetic_jacappella_corpus`` (an int16
and a 24-bit wav at 24 kHz, the second resampled to 48 kHz), with harvest
and with dio + stonemask, with and without the F0 smoothing: the
(log-mel, lf0, vuv) features and the waveform bitwise, since the port's
WORLD analysis is bitwise the JAX package's (``tests/
test_torch_world_analysis.py``).
"""

import numpy as np
import pytest

from ensemble_svs_with_interactions_tpu.data import data_source as jds
from ensemble_svs_with_interactions_tpu_torch.data import data_source as ds
from tests.util import HED, build_synthetic_jacappella_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return build_synthetic_jacappella_corpus(
        tmp_path_factory.mktemp("mel_corpus"))


@pytest.mark.parametrize("kw", [
    {},
    {"fft_size": 1024, "hop_size": 240, "win_length": 960, "fmin": 63.0,
     "fmax": 20000.0, "num_mels": 80},
    {"fft_size": 256, "hop_size": 60, "num_mels": 40, "eps": 1e-6},
], ids=["defaults", "48k_recipe", "narrow"])
def test_logmelfilterbank_matches_jax_bitwise(kw):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(0, 0.3, 12001),
                        np.zeros(500)]).astype(np.float64)
    got = ds.logmelfilterbank(x, 48000, **kw)
    ref = jds.logmelfilterbank(x, 48000, **kw)
    assert got.dtype == ref.dtype == np.float32
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", [
    {"spk": "alto", "song": 0, "sample_rate": 24000, "hop_size": 120,
     "fft_size": 512, "win_length": 480},
    {"spk": "soprano", "song": 1, "sample_rate": 48000, "hop_size": 240,
     "fft_size": 1024, "win_length": 960, "f0_extractor": "dio",
     "trajectory_smoothing_f0": False, "fmin": 63.0},
], ids=["harvest_24k_int16", "dio_48k_int32"])
def test_melf0_source_matches_jax(corpus, case):
    """(features, waveform, features) of ``collect_features`` bitwise,
    the widths (80 mels, lf0, vuv), a 0/1 vuv and a finite lf0."""
    case = dict(case)
    spk, song = case.pop("spk"), case.pop("song")
    args = ("unused.list", str(corpus / spk), str(corpus / spk), HED)
    wav = corpus / spk / f"song{song}.wav"
    lab = corpus / spk / f"song{song}_aligned.lab"
    got = ds.MelF0AcousticSource(*args, **case).collect_features(wav, lab)
    ref = jds.MelF0AcousticSource(*args, **case).collect_features(wav, lab)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float32 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    feats, wave, _ = got
    assert feats.shape[1] == 82
    assert len(wave) == len(feats) * case["hop_size"]
    assert set(np.unique(feats[:, 81])) <= {0.0, 1.0}
    assert np.isfinite(feats).all() and feats[:, 81].any()


def test_melf0_source_collects_its_files(tmp_path):
    """``collect_files`` lists the wavs and labels of the utterance list,
    as the JAX source does."""
    (tmp_path / "utts.list").write_text("a\nb\n\n")
    args = (str(tmp_path / "utts.list"), "w", "l", HED)
    assert ds.MelF0AcousticSource(*args).collect_files() == \
        jds.MelF0AcousticSource(*args).collect_files()
