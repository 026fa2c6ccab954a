"""WORLD spectral-envelope and aperiodicity decoding for the coded-stream
vocoder: the ``basis="world"`` tables of
``ensemble_svs_with_interactions_tpu/ops/world/codec.py`` (pyworld's
CodeSpectralEnvelope / DecodeSpectralEnvelope, WORLD src/codec.cpp),
built in NumPy float64, the aperiodicity decode as a torch gather, and
its coder (``code_aperiodicity``, host NumPy) for the neural vocoders'
aperiodicity round trip; and the coders of feature extraction (host
NumPy, the JAX module's NumPy branch): ``code_spectral_envelope`` under
either basis (``"world"``, pyworld's CodeSpectralEnvelope, or the legacy
``"orthonormal"``; ``ESVS_SPECTRAL_CODEC_BASIS`` sets the default) and
``decode_aperiodicity_np``, the decode D4C's band values go through.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

# WORLD constants (world/constantnumbers.h)
FREQUENCY_INTERVAL = 3000.0
UPPER_LIMIT = 15000.0
FLOOR_FREQUENCY = 40.0
CEIL_FREQUENCY = 20000.0
FLOOR_F0 = 71.0
SAFE_GUARD_MINIMUM = 1e-12
MIN_DB = -60.0


def get_cheaptrick_fft_size(fs: int, f0_floor: float = FLOOR_F0) -> int:
    """FFT size used by CheapTrick: 2^ceil(log2(3 fs / f0_floor + 1))."""
    return int(2 ** (1 + int(np.log2(3.0 * fs / f0_floor + 1.0))))


def get_num_aperiodicities(fs: int) -> int:
    """Number of coded band aperiodicities (3 kHz bands capped at 15 kHz)."""
    return int(min(UPPER_LIMIT, fs / 2.0 - FREQUENCY_INTERVAL)
               / FREQUENCY_INTERVAL)


def _freq_to_mel(f):
    return 1127.01048 * np.log(f / 700.0 + 1.0)


def _ortho_dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)
    dct = np.cos(np.pi * (k[:, None]) * (2 * k[None, :] + 1) / (2 * n))
    dct *= np.sqrt(2.0 / n)
    dct[0] *= np.sqrt(0.5)
    return dct


def _mel_to_freq(m):
    return 700.0 * (np.exp(m / 1127.01048) - 1.0)


@lru_cache(maxsize=8)
def _world_codec_tables(fs: int, fft_size: int):
    """Gathers and scaled DCT matrices of the ``basis="world"`` codec
    (WORLD src/codec.cpp): ``code_gather = (i0, w1)`` resamples the log
    envelope from FFT bins onto the mel grid (linear in mel),
    ``decode_gather = (a0, a1, v1)`` resamples back through WORLD's
    endpoint-extended anchor axis; the DCT matrices carry WORLD's
    normalization (orthonormal / sqrt(N) forward, * sqrt(N) inverse)."""
    half = fft_size // 2
    n_bins = half + 1
    bin_mels = _freq_to_mel(np.arange(n_bins) * fs / fft_size)
    floor_mel = _freq_to_mel(FLOOR_FREQUENCY)
    ceil_mel = _freq_to_mel(min(fs / 2.0, CEIL_FREQUENCY))
    mel_axis = floor_mel + (ceil_mel - floor_mel) * np.arange(half) / half

    pos = np.interp(mel_axis, bin_mels, np.arange(n_bins, dtype=np.float64))
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, n_bins - 2)
    w1 = pos - i0

    anchors = np.concatenate([[0.0], mel_axis, [_freq_to_mel(fs / 2.0)]])
    pos_inv = np.interp(bin_mels, anchors,
                        np.arange(half + 2, dtype=np.float64))
    j0 = np.clip(np.floor(pos_inv).astype(np.int64), 0, half)
    v1 = pos_inv - j0
    a0 = np.clip(j0 - 1, 0, half - 1)
    a1 = np.clip(j0, 0, half - 1)

    dct = _ortho_dct_matrix(half)
    code_dct = dct / np.sqrt(half)
    decode_dct = dct * np.sqrt(half)
    return ((i0, w1.astype(np.float64)), (a0, a1, v1.astype(np.float64)),
            code_dct, decode_dct)


def default_spectral_codec_basis() -> str:
    """The spectral codec's basis: ``"world"`` unless
    ``ESVS_SPECTRAL_CODEC_BASIS`` says otherwise."""
    return os.environ.get("ESVS_SPECTRAL_CODEC_BASIS", "world")


@lru_cache(maxsize=8)
def _mel_axis_weights(fs: int, fft_size: int):
    """Tables of the legacy ``basis="orthonormal"`` codec: gathers for
    linear -> mel and mel -> linear resampling of the log envelope over
    [one FFT bin, fs/2], and the orthonormal DCT."""
    half = fft_size // 2
    linear_freqs = np.arange(half + 1) * fs / fft_size
    mel_lo = _freq_to_mel(float(fs) / fft_size)
    mel_hi = _freq_to_mel(fs / 2.0)
    mel_axis = np.linspace(mel_lo, mel_hi, half)
    mel_freqs = _mel_to_freq(mel_axis)

    pos = mel_freqs / (fs / fft_size)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, half)
    i1 = np.clip(i0 + 1, 0, half)
    w1 = pos - i0
    pos_inv = np.interp(linear_freqs, mel_freqs, np.arange(half))
    j0 = np.clip(np.floor(pos_inv).astype(np.int64), 0, half - 1)
    j1 = np.clip(j0 + 1, 0, half - 1)
    v1 = pos_inv - j0

    dct = _ortho_dct_matrix(half)
    return ((i0, i1, w1.astype(np.float64)), (j0, j1, v1.astype(np.float64)),
            dct)


def code_spectral_envelope(spectrogram: np.ndarray, fs: int,
                           number_of_dimensions: int,
                           basis: str | None = None) -> np.ndarray:
    """(T, fft//2+1) power envelope -> (T, D) code (host NumPy):
    ``basis="world"`` is pyworld's CodeSpectralEnvelope, ``"orthonormal"``
    the legacy self-consistent codec."""
    basis = basis or default_spectral_codec_basis()
    fft_size = (spectrogram.shape[-1] - 1) * 2
    log_sp = np.log(spectrogram)
    if basis == "world":
        (i0, w1), _, code_dct, _ = _world_codec_tables(fs, fft_size)
        mel_sp = log_sp[..., i0] * (1.0 - w1) + log_sp[..., i0 + 1] * w1
        return mel_sp @ code_dct[:number_of_dimensions].T
    if basis != "orthonormal":
        raise ValueError(f"unknown spectral codec basis: {basis!r}")
    (i0, i1, w1), _, dct = _mel_axis_weights(fs, fft_size)
    mel_sp = log_sp[..., i0] * (1.0 - w1) + log_sp[..., i1] * w1
    coded = mel_sp @ dct.T
    return coded[..., :number_of_dimensions]


@lru_cache(maxsize=8)
def _world_decode_tables(fs: int, fft_size: int):
    """(a0, a1, v1) mel-envelope -> FFT-bin interpolation through WORLD's
    endpoint-extended anchor axis, and the inverse DCT scaled by sqrt(N)."""
    half = fft_size // 2
    bin_mels = _freq_to_mel(np.arange(half + 1) * fs / fft_size)
    floor_mel = _freq_to_mel(FLOOR_FREQUENCY)
    ceil_mel = _freq_to_mel(min(fs / 2.0, CEIL_FREQUENCY))
    mel_axis = floor_mel + (ceil_mel - floor_mel) * np.arange(half) / half
    anchors = np.concatenate([[0.0], mel_axis, [_freq_to_mel(fs / 2.0)]])
    pos_inv = np.interp(bin_mels, anchors,
                        np.arange(half + 2, dtype=np.float64))
    j0 = np.clip(np.floor(pos_inv).astype(np.int64), 0, half)
    v1 = pos_inv - j0
    a0 = np.clip(j0 - 1, 0, half - 1)
    a1 = np.clip(j0, 0, half - 1)
    return a0, a1, v1, _ortho_dct_matrix(half) * np.sqrt(half)


def decode_spectral_envelope_np(coded: np.ndarray, fs: int,
                                fft_size: int) -> np.ndarray:
    """(T, D) code -> (T, fft//2+1) power envelope, float64 NumPy."""
    a0, a1, v1, decode_dct = _world_decode_tables(fs, fft_size)
    mel_sp = coded @ decode_dct[: coded.shape[-1], :]
    return np.exp(mel_sp[..., a0] * (1.0 - v1) + mel_sp[..., a1] * v1)


@lru_cache(maxsize=8)
def spectral_decode_cepstrum_basis(fs: int, fft_size: int,
                                   dim: int) -> np.ndarray:
    """(dim, fft_size) f32 matrix taking coded mgc straight to the folded
    min-phase cepstrum: ``exp(rfft(coded @ M))`` is the min-phase transfer
    function of the decoded envelope (decode, 0.5 log, irfft and the fold
    are all linear in the code)."""
    logw = np.log(decode_spectral_envelope_np(np.eye(dim), fs, fft_size))
    c = np.fft.irfft(0.5 * logw, n=fft_size, axis=-1)
    half = fft_size // 2
    folded = np.concatenate(
        [c[:, :1], 2.0 * c[:, 1:half], c[:, half: half + 1],
         np.zeros((dim, fft_size - half - 1))], axis=1)
    return folded.astype(np.float32)


@lru_cache(maxsize=8)
def _aperiodicity_interp_weights(fs: int, fft_size: int):
    n = get_num_aperiodicities(fs)
    freqs = np.arange(fft_size // 2 + 1) * fs / fft_size
    anchors = np.concatenate(
        [[0.0], FREQUENCY_INTERVAL * np.arange(1, n + 1), [fs / 2.0]])
    seg = np.clip(np.searchsorted(anchors, freqs, side="right") - 1, 0, n)
    w = (freqs - anchors[seg]) / (anchors[seg + 1] - anchors[seg])
    return n, seg.astype(np.int64), w


def decode_aperiodicity(coded_aperiodicity, fs: int, fft_size: int):
    """(..., n_bands) dB codes -> (..., fft//2+1) linear aperiodicity, in
    the codes' dtype (the interpolation weights too: float64 codes decode
    as the JAX package's host NumPy decodes them)."""
    _, seg, w = _aperiodicity_interp_weights(fs, fft_size)
    dev = coded_aperiodicity.device
    seg = torch.from_numpy(seg).to(dev)
    w = torch.from_numpy(w).to(dev, coded_aperiodicity.dtype)
    lead = coded_aperiodicity.shape[:-1]
    lo = coded_aperiodicity.new_full(lead + (1,), MIN_DB)
    # WORLD anchors the nyquist end at -kMySafeGuardMinimum dB (~0 dB)
    hi = coded_aperiodicity.new_full(lead + (1,), -SAFE_GUARD_MINIMUM)
    anchors_db = torch.cat([lo, coded_aperiodicity, hi], dim=-1)
    db = anchors_db[..., seg] * (1.0 - w) + anchors_db[..., seg + 1] * w
    return torch.pow(10.0, db / 20.0)


def code_aperiodicity(aperiodicity: np.ndarray, fs: int) -> np.ndarray:
    """(..., fft//2+1) linear aperiodicity -> (..., n_bands) dB band values
    (host NumPy): the spectrum in dB, interpolated linearly at the band
    centres k * 3 kHz, as WORLD's CodeAperiodicity does."""
    fft_size = (aperiodicity.shape[-1] - 1) * 2
    n = get_num_aperiodicities(fs)
    pos = (FREQUENCY_INTERVAL * np.arange(1, n + 1)) * fft_size / fs
    i0 = np.minimum(np.floor(pos).astype(np.int64), fft_size // 2)
    i1 = np.minimum(i0 + 1, fft_size // 2)
    w1 = pos - i0
    db = 20.0 * np.log10(np.maximum(aperiodicity, SAFE_GUARD_MINIMUM))
    return db[..., i0] * (1.0 - w1) + db[..., i1] * w1


def decode_aperiodicity_np(coded_aperiodicity: np.ndarray, fs: int,
                           fft_size: int) -> np.ndarray:
    """(T, n_bands) dB codes -> (T, fft//2+1) linear aperiodicity, host
    NumPy (what ``decode_aperiodicity`` computes on a tensor)."""
    _, seg, w = _aperiodicity_interp_weights(fs, fft_size)
    T = coded_aperiodicity.shape[0]
    lo_db = np.full((T, 1), MIN_DB, dtype=coded_aperiodicity.dtype)
    hi_db = np.full((T, 1), -SAFE_GUARD_MINIMUM,
                    dtype=coded_aperiodicity.dtype)
    anchors_db = np.concatenate([lo_db, coded_aperiodicity, hi_db], axis=-1)
    db = anchors_db[..., seg] * (1.0 - w) + anchors_db[..., seg + 1] * w
    return np.power(10.0, db / 20.0)
