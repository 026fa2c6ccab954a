"""WORLD spectral-envelope and aperiodicity decoding for the coded-stream
vocoder: the ``basis="world"`` tables of
``ensemble_svs_with_interactions_tpu/ops/world/codec.py`` (pyworld's
CodeSpectralEnvelope / DecodeSpectralEnvelope, WORLD src/codec.cpp),
built in NumPy float64, and the aperiodicity decode as a torch gather.
"""

from __future__ import annotations

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
    return n, seg.astype(np.int64), w.astype(np.float32)


def decode_aperiodicity(coded_aperiodicity, fs: int, fft_size: int):
    """(..., n_bands) dB codes -> (..., fft//2+1) linear aperiodicity."""
    _, seg, w = _aperiodicity_interp_weights(fs, fft_size)
    dev = coded_aperiodicity.device
    seg = torch.from_numpy(seg).to(dev)
    w = torch.from_numpy(w).to(dev)
    lead = coded_aperiodicity.shape[:-1]
    lo = coded_aperiodicity.new_full(lead + (1,), MIN_DB)
    # WORLD anchors the nyquist end at -kMySafeGuardMinimum dB (~0 dB)
    hi = coded_aperiodicity.new_full(lead + (1,), -SAFE_GUARD_MINIMUM)
    anchors_db = torch.cat([lo, coded_aperiodicity, hi], dim=-1)
    db = anchors_db[..., seg] * (1.0 - w) + anchors_db[..., seg + 1] * w
    return torch.pow(10.0, db / 20.0)
