"""The port's host-side WORLD analysis and feature helpers against the JAX
package's on the CPU.

Both packages read ``ESVS_DISABLE_NATIVE``, so each check runs twice: on
the native path (the JAX package's library against the port's own build
of the same C++ source) and on the NumPy path.  Port against JAX is
bitwise on each path; the port's native path against its NumPy path is
held at ``tests/test_native.py``'s tolerances.  Signals are seeded, short
(0.6 s) and at the recipe's 48 kHz and the e2e corpus's 24 kHz.
"""

import ctypes
import os
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

from ensemble_svs_with_interactions_tpu import native as jax_native
from ensemble_svs_with_interactions_tpu.data import data_source as jds
from ensemble_svs_with_interactions_tpu.ops import mlpg as jmlpg
from ensemble_svs_with_interactions_tpu.ops import pitch as jpitch
from ensemble_svs_with_interactions_tpu.ops import praat as jpraat
from ensemble_svs_with_interactions_tpu.ops import sptk as jsptk
from ensemble_svs_with_interactions_tpu.ops.world import analysis as jan
from ensemble_svs_with_interactions_tpu.ops.world import codec as jcodec
from ensemble_svs_with_interactions_tpu_torch import native
from ensemble_svs_with_interactions_tpu_torch.data import data_source as ds
from ensemble_svs_with_interactions_tpu_torch.ops import mlpg, pitch, praat
from ensemble_svs_with_interactions_tpu_torch.ops import sptk
from ensemble_svs_with_interactions_tpu_torch.ops.world import analysis as an
from ensemble_svs_with_interactions_tpu_torch.ops.world import codec
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

RATES = (24000, 48000)
PATHS = ("native", "numpy")


def make_signal(fs: int, seed: int = 7, seconds: float = 0.6):
    """A sung vowel stand-in: five harmonics of a G3 with 5.5 Hz vibrato,
    light noise, and an unvoiced (noise-only) head."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    f0 = 196.0 * (1 + 0.08 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = sum(a * np.sin(k * phase)
            for k, a in enumerate([1.0, 0.5, 0.3, 0.2, 0.1], start=1))
    x = 0.3 * x + 0.02 * rng.standard_normal(len(t))
    head = int(0.12 * fs)
    x[:head] = 0.02 * rng.standard_normal(head)
    return x


@pytest.fixture(params=PATHS)
def path(request, monkeypatch):
    """Selects the analysis path of both packages."""
    if request.param == "numpy":
        monkeypatch.setenv("ESVS_DISABLE_NATIVE", "1")
    else:
        monkeypatch.delenv("ESVS_DISABLE_NATIVE", raising=False)
        assert native.available() and jax_native.available()
    return request.param


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _numpy_path(fn, *args, **kwargs):
    os.environ["ESVS_DISABLE_NATIVE"] = "1"
    try:
        return fn(*args, **kwargs)
    finally:
        del os.environ["ESVS_DISABLE_NATIVE"]


# ------------------------------------------------------------ port vs JAX


@pytest.mark.parametrize("fs", RATES)
def test_f0_estimators_match_jax(fs, path):
    """dio, harvest and stonemask (and dio's NCCF candidates and Viterbi
    track under them) bitwise the JAX package's on the same path."""
    x = make_signal(fs)
    _same(an.dio(x, fs, f0_floor=100.0, f0_ceil=700.0),
          jan.dio(x, fs, f0_floor=100.0, f0_ceil=700.0))
    f0, t = an.harvest(x, fs, f0_floor=100.0, f0_ceil=700.0)
    _same((f0, t), jan.harvest(x, fs, f0_floor=100.0, f0_ceil=700.0))
    assert (f0 > 0).mean() > 0.5
    _same(an.stonemask(x, f0, t, fs), jan.stonemask(x, f0, t, fs))


@pytest.mark.parametrize("fs", RATES)
def test_envelope_and_aperiodicity_match_jax(fs, path):
    """cheaptrick and d4c (at the recipe's threshold and the default)
    bitwise the JAX package's on the same path."""
    x = make_signal(fs, seed=3)
    f0, t = jan.harvest(x, fs)
    sp = an.cheaptrick(x, f0, t, fs)
    _same(sp, jan.cheaptrick(x, f0, t, fs))
    assert sp.shape == (len(f0), codec.get_cheaptrick_fft_size(fs) // 2 + 1)
    for threshold in (0.15, 0.85):
        _same(an.d4c(x, f0, t, fs, threshold=threshold),
              jan.d4c(x, f0, t, fs, threshold=threshold))


def test_non_power_of_two_fft_takes_numpy_in_both():
    """A CheapTrick FFT size that is no power of two runs the NumPy branch
    even where the native library is loaded."""
    fs = 24000
    x = make_signal(fs)
    f0, t = jan.harvest(x, fs)
    _same(an.cheaptrick(x, f0, t, fs, fft_size=1536),
          jan.cheaptrick(x, f0, t, fs, fft_size=1536))
    _same(an.d4c(x, f0, t, fs, fft_size=1536),
          jan.d4c(x, f0, t, fs, fft_size=1536))


# ----------------------------------------------- native vs NumPy (port)


@pytest.mark.parametrize("fs", RATES)
def test_native_matches_numpy_path(fs):
    """The port's native kernels against its NumPy path, at
    tests/test_native.py's tolerances."""
    assert native.available()
    x = make_signal(fs)
    centers = np.arange(0, len(x) - 1, fs // 200, dtype=np.int64)
    got = an._nccf_candidates(x, fs, centers, 71.0, 800.0, 5)
    want = _numpy_path(an._nccf_candidates, x, fs, centers, 71.0, 800.0, 5)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-9)

    f0, ts = an.harvest(x, fs)
    f0_np, ts_np = _numpy_path(an.harvest, x, fs)
    np.testing.assert_allclose(ts, ts_np)
    np.testing.assert_allclose(f0, f0_np, rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(an.cheaptrick(x, f0, ts, fs),
                               _numpy_path(an.cheaptrick, x, f0, ts, fs),
                               rtol=1e-6)
    np.testing.assert_allclose(an.d4c(x, f0, ts, fs),
                               _numpy_path(an.d4c, x, f0, ts, fs),
                               rtol=1e-6, atol=1e-9)
    f0d, td = an.dio(x, fs)
    np.testing.assert_allclose(an.stonemask(x, f0d, td, fs),
                               _numpy_path(an.stonemask, x, f0d, td, fs),
                               rtol=1e-9, atol=1e-9)


# ------------------------------------------------------- the native layer


def test_cpp_source_is_the_jax_packages():
    """The port builds its own copy of the C++ source into its own
    ``_build/``: the JAX package's bytes, but for one comment whose
    reference path the port's copy gives from ``nnsvs/`` on, without the
    directory of a reference checkout."""
    port = (Path(native.__file__).parent / "world_kernels.cpp").read_bytes()
    jax_src = (Path(jax_native.__file__).parent /
               "world_kernels.cpp").read_bytes()
    jl, pl = jax_src.splitlines(True), port.splitlines(True)
    differ = [i for i, (a, b) in enumerate(zip(jl, pl)) if a != b]
    assert len(jl) == len(pl) and len(differ) == 1, differ
    a, b = jl[differ[0]], pl[differ[0]]
    assert b == a[:a.index(b"(") + 1] + a[a.index(b"nnsvs/"):], (a, b)
    assert native.available()
    so = native._so_path()
    assert so.parent == Path(native.__file__).parent.parent / "_build"
    assert so.exists() and native.lib()._name == str(so)
    assert native.CXX_FLAGS == ("-O3", "-std=c++17", "-shared", "-fPIC",
                                "-fno-math-errno")


def test_disable_env_var(monkeypatch):
    monkeypatch.setenv("ESVS_DISABLE_NATIVE", "1")
    assert not native.available() and native.lib() is None
    monkeypatch.setenv("ESVS_DISABLE_NATIVE", "0")
    assert native.available()


def test_stale_library_falls_back(monkeypatch):
    """A cached library missing a newer export (AttributeError from dlsym)
    that cannot be rebuilt leaves the NumPy path serving, without raising
    again; a fresh state with a working binding restores the library."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)

    def bad_declare(lib):
        raise AttributeError("undefined symbol: esvs_new_kernel")

    monkeypatch.setattr(native, "_declare", bad_declare)
    monkeypatch.setattr(native, "_build", lambda so: False)
    assert native.lib() is None
    assert native.available() is False
    fs = 24000
    x = make_signal(fs)
    _same(an.harvest(x, fs), _numpy_path(jan.harvest, x, fs))
    monkeypatch.undo()
    native._TRIED = False
    native._LIB = None
    assert native.available()


def test_build_writes_through_a_temporary_file(tmp_path, monkeypatch):
    """A build links a temporary file and renames it into place (the
    process pool races the first build); a failed build leaves nothing."""
    so = tmp_path / "sub" / "_world_kernels_test.so"
    assert native._build(so)
    assert so.exists() and not list(so.parent.glob("*.tmp*"))
    lib = native._declare(ctypes.CDLL(str(so)))
    assert lib.esvs_cheaptrick is not None
    monkeypatch.setattr(native, "_SRC", tmp_path / "missing.cpp")
    bad = tmp_path / "sub" / "_bad.so"
    assert not native._build(bad)
    assert not bad.exists() and not list(so.parent.glob("*.tmp*"))


# --------------------------------------------------- codecs and helpers


@pytest.mark.parametrize("fs", RATES)
@pytest.mark.parametrize("basis", ("world", "orthonormal"))
def test_code_spectral_envelope_matches_jax(fs, basis):
    rng = np.random.default_rng(1)
    fft = codec.get_cheaptrick_fft_size(fs)
    sp = np.exp(rng.normal(size=(7, fft // 2 + 1)))
    for dims in (8, 60):
        _same(codec.code_spectral_envelope(sp, fs, dims, basis=basis),
              jcodec.code_spectral_envelope(sp, fs, dims, basis=basis))
    with pytest.raises(ValueError):
        codec.code_spectral_envelope(sp, fs, 8, basis="dct")


def test_default_codec_basis_reads_the_environment(monkeypatch):
    monkeypatch.delenv("ESVS_SPECTRAL_CODEC_BASIS", raising=False)
    assert codec.default_spectral_codec_basis() == "world"
    monkeypatch.setenv("ESVS_SPECTRAL_CODEC_BASIS", "orthonormal")
    assert codec.default_spectral_codec_basis() == "orthonormal"
    rng = np.random.default_rng(2)
    sp = np.exp(rng.normal(size=(3, 1025)))
    _same(codec.code_spectral_envelope(sp, 48000, 8),
          jcodec.code_spectral_envelope(sp, 48000, 8,
                                        basis="orthonormal"))


@pytest.mark.parametrize("fs", RATES)
def test_aperiodicity_codecs_match_jax(fs):
    rng = np.random.default_rng(4)
    fft = codec.get_cheaptrick_fft_size(fs)
    n = codec.get_num_aperiodicities(fs)
    coded = rng.uniform(-40, 0, size=(9, n))
    _same(codec.decode_aperiodicity_np(coded, fs, fft),
          jcodec.decode_aperiodicity(coded, fs, fft))
    ap = rng.uniform(1e-3, 1.0, size=(9, fft // 2 + 1))
    _same(codec.code_aperiodicity(ap, fs), jcodec.code_aperiodicity(ap, fs))


@pytest.mark.parametrize("order", (7, 24, 59))
def test_sp2mc_and_mc2b_match_jax(order):
    rng = np.random.default_rng(order)
    sp = np.exp(rng.normal(size=(5, 1025)))
    alpha = sptk.mcepalpha(48000)
    mc = sptk.sp2mc(sp, order, alpha)
    _same(mc, jsptk.sp2mc(sp, order, alpha))
    _same(sptk.mc2b(mc, alpha), jsptk.mc2b(mc, alpha))


@pytest.mark.parametrize("fs", RATES)
def test_sound_to_pitch_ac_matches_jax(fs):
    x = make_signal(fs, seed=5)
    kw = dict(time_step=0.005, pitch_floor=120.0, pitch_ceiling=700.0,
              voicing_threshold=0.6)
    got = praat.sound_to_pitch_ac(x, fs, **kw)
    _same(got, jpraat.sound_to_pitch_ac(x, fs, **kw))
    assert (got[0] > 0).mean() > 0.5
    _same(praat.sound_to_pitch_ac(np.zeros(fs // 10), fs, **kw),
          jpraat.sound_to_pitch_ac(np.zeros(fs // 10), fs, **kw))


def _vibrato_f0(sr=200, seconds=4.0, seed=0):
    """A voiced F0 track (Hz): a flat note, an unvoiced gap, then a note
    with 6 Hz, 60-cent vibrato from its onset."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    onset = 1.6
    cents = 60.0 * np.sin(2 * np.pi * 6.0 * (t - onset)) * (t > onset)
    f0 = 330.0 * 2 ** (cents / 1200) + rng.normal(0, 0.05, len(t))
    f0[:15] = 0.0
    f0[300:320] = 0.0
    return f0


def test_pitch_helpers_match_jax():
    sr = 200
    f0 = _vibrato_f0(sr)
    _same(pitch.hz_to_cent_based_c4(f0), jpitch.hz_to_cent_based_c4(f0))
    for cutoff in (3, 8, 20):
        _same(pitch.extract_smoothed_f0(f0, sr, cutoff=cutoff),
              jpitch.extract_smoothed_f0(f0, sr, cutoff=cutoff))
    lf0 = jpitch.interp1d(np.where(f0 > 0, np.log(np.maximum(f0, 1)), 0))
    _same(pitch.extract_smoothed_continuous_f0(lf0[:, None], sr),
          jpitch.extract_smoothed_continuous_f0(lf0[:, None], sr))
    score = np.where(f0 > 0, 329.0, 0.0)
    score[400:] = 392.0 * (f0[400:] > 0)
    ratio = pitch.compute_f0_correction_ratio(f0, score)
    assert ratio == jpitch.compute_f0_correction_ratio(f0, score) != 1.0


def test_vibrato_extractors_match_jax():
    sr = 200
    f0 = _vibrato_f0(sr)
    smooth = jpitch.extract_smoothed_f0(f0, sr, cutoff=8)
    cent = jpitch.hz_to_cent_based_c4(smooth)
    like = pitch.extract_vibrato_likelihood(cent, sr, win_length=64,
                                            n_fft=256)
    _same(like, jpitch.extract_vibrato_likelihood(cent, sr, win_length=64,
                                                  n_fft=256))
    got = pitch.extract_vibrato_parameters(cent, like, sr, threshold=0.12)
    _same(got, jpitch.extract_vibrato_parameters(cent, like, sr,
                                                 threshold=0.12))
    assert got[0].sum() > 0  # the vibrato was found


@pytest.mark.parametrize("num_windows", (1, 2, 3))
def test_apply_delta_windows_matches_jax(num_windows):
    rng = np.random.default_rng(num_windows)
    x = rng.normal(size=(37, 5)).astype(np.float32)
    wins = mlpg.default_windows(num_windows)
    got = mlpg.apply_delta_windows(x, wins)
    _same(got, jmlpg.apply_delta_windows(x, jmlpg.default_windows(
        num_windows)))
    assert got.shape == (37, 5 * num_windows)


@pytest.mark.parametrize("kind", ("int16", "int24", "float32"))
@pytest.mark.parametrize("target", (None, 48000, 16000))
def test_load_wav_matches_jax(tmp_path, kind, target):
    """16-bit, 24-bit (scipy reads it as int32) and float wavs, kept at
    24 kHz or resampled, bitwise the JAX reader's."""
    rng = np.random.default_rng(9)
    x = 0.5 * np.sin(2 * np.pi * 220 * np.arange(2400) / 24000)
    x = x + 0.01 * rng.standard_normal(2400)
    if kind == "int16":
        data = (x * 32767).astype(np.int16)
    elif kind == "int24":
        data = ((x * 32767).astype(np.int64) << 16).astype(np.int32)
    else:
        data = x.astype(np.float32)
    p = tmp_path / f"{kind}.wav"
    wavfile.write(p, 24000, data)
    got = ds.load_wav(p, target)
    _same(got[0], jds.load_wav(p, target)[0])
    assert got[1] == jds.load_wav(p, target)[1] == (target or 24000)
    assert np.abs(got[0]).max() < 1.0


def test_melf0_features_are_refused():
    """The WORLD source refuses mel features, pointing at the mel source,
    as the JAX package's does."""
    from ensemble_svs_with_interactions_tpu_torch.utils import (
        packaged_question_path,
    )

    with pytest.raises(ValueError, match="MelF0 source"):
        ds.WORLDAcousticSource("u.list", "w", "l", packaged_question_path(),
                               feature_type="melf0")
    with pytest.raises(ValueError):
        ds.WORLDAcousticSource("u.list", "w", "l", packaged_question_path(),
                               feature_type="mel")
