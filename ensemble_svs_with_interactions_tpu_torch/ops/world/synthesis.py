"""Coded-stream WORLD synthesis, batched over tracks: the counterpart of
``_synthesize_from_streams_impl`` / ``_from_streams_single_body`` /
``_synthesize_from_transfer`` in
``ensemble_svs_with_interactions_tpu/ops/world/synthesis.py``.

mgc goes to the folded min-phase cepstrum through one precomputed matmul
(full float32: TF32 is off, the JAX package uses Precision.HIGHEST), the
70 Hz output high-pass is a constant cepstrum offset, and the excitation
(a fractionally-delayed pulse train plus white noise) is filtered per
frame by an fft_size-point circular FFT product and overlap-added.

The noise is an explicit argument (B, T * hop), so callers choose its
generator and tests can feed both frameworks the same numbers.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ensemble_svs_with_interactions_tpu_torch.ops.world.codec import (
    decode_aperiodicity,
    get_cheaptrick_fft_size,
    spectral_decode_cepstrum_basis,
)

# pulse amplitude factor sqrt(1.06 / 1.73), as in the JAX package
PULSE_CALIBRATION = 0.783


def _overlap_add(chunks, hop: int, out_len: int):
    """OLA (B, T, L) chunks at stride ``hop`` into (B, out_len) signals."""
    B, T, L = chunks.shape
    K = -(-L // hop)
    chunks = F.pad(chunks, (0, K * hop - L))
    pieces = chunks.reshape(B, T, K, hop)
    acc = chunks.new_zeros(B, T + K, hop)
    for k in range(K):
        acc[:, k: k + T] += pieces[:, :, k, :]
    return acc.reshape(B, -1)[:, :out_len]


def _wrapped_phase(inc):
    """Cumulative phase mod 1 (cycles) of per-sample increments (B, N),
    float32, accumulated in blocks of 4096 samples so the running sum
    stays small (fractional resolution)."""
    NB = 4096
    B, N = inc.shape
    n_blocks = -(-N // NB)
    inner = torch.cumsum(F.pad(inc, (0, n_blocks * NB - N)).reshape(
        B, n_blocks, NB), dim=2)
    block_tot = torch.remainder(inner[:, :, -1], 1.0)
    offsets = torch.remainder(
        torch.cat([inner.new_zeros(B, 1),
                   torch.cumsum(block_tot, dim=1)[:, :-1]], dim=1), 1.0)
    return torch.remainder(offsets[:, :, None] + inner, 1.0).reshape(
        B, -1)[:, :N]


def _synthesize_from_transfer(f0, H, ap, noise, fs: int, hop: int,
                              fft_size: int):
    """Excitation + time-varying filtering: f0 (B, T) Hz (0 = unvoiced),
    H (B, T, fft//2+1) complex min-phase transfer function, ap (B, T,
    fft//2+1) aperiodicity, noise (B, T*hop) -> (B, T*hop)."""
    B, T = f0.shape
    N = T * hop
    voiced = f0 > 0.0
    f0_safe = torch.where(voiced, f0, torch.ones_like(f0))
    f0_samples = torch.repeat_interleave(
        torch.where(voiced, f0, torch.zeros_like(f0)), hop, dim=1)
    inc = f0_samples / fs
    phase = _wrapped_phase(inc)
    prev_phase = torch.cat([phase.new_zeros(B, 1), phase[:, :-1]], dim=1)
    new_pulse = phase < prev_phase
    amp = PULSE_CALIBRATION * torch.sqrt(
        fs / torch.repeat_interleave(f0_safe, hop, dim=1))
    mu = (phase / inc.clamp_min(1e-9)).clamp(0.0, 1.0)
    a = torch.where(new_pulse & (f0_samples > 0), amp, torch.zeros_like(amp))
    # fractional pulse delay: an 8-tap Hann-windowed sinc split
    HALF = 4
    pulses = torch.zeros_like(a)
    for j in range(-HALF, HALF):
        u = j + mu
        tap = a * (torch.sinc(u) * (0.5 + 0.5 * torch.cos(np.pi * u / HALF)))
        if j < 0:
            tap = F.pad(tap[:, -j:], (0, -j))
        elif j > 0:
            tap = F.pad(tap[:, :-j], (j, 0))
        pulses = pulses + tap

    ap2 = ap.clamp(0.0, 1.0) ** 2
    ap2 = torch.where(voiced[..., None], ap2, torch.ones_like(ap2))
    exc = torch.stack([pulses, noise.to(torch.float32)], dim=1).reshape(
        B, 2, T, hop)
    X = torch.fft.rfft(exc, n=fft_size, dim=-1)
    w_per = torch.sqrt((1.0 - ap2).clamp_min(0.0))
    w_apr = torch.sqrt(ap2)
    Y = (X[:, 0] * w_per + X[:, 1] * w_apr) * H
    y = torch.fft.irfft(Y, n=fft_size, dim=-1)
    return _overlap_add(y, hop, N)


def _highpass_mask(fs: int, fft_size: int, cutoff: float):
    """Raised-cosine high-pass weights over rfft bins (0 at 0.5 cutoff, 1
    at 1.5 cutoff)."""
    freqs = np.arange(fft_size // 2 + 1) * fs / fft_size
    lo, hi = 0.5 * cutoff, 1.5 * cutoff
    t = np.clip((freqs - lo) / (hi - lo), 0.0, 1.0)
    return (0.5 - 0.5 * np.cos(np.pi * t)).astype(np.float32)


@lru_cache(maxsize=8)
def _highpass_cepstrum(fs: int, fft_size: int, cutoff: float):
    """Folded min-phase cepstrum of the high-pass amplitude mask."""
    hp = _highpass_mask(fs, fft_size, cutoff).astype(np.float64)
    c = np.fft.irfft(np.log(np.maximum(hp, 1e-7)), n=fft_size)
    half = fft_size // 2
    return np.concatenate(
        [c[:1], 2.0 * c[1:half], c[half: half + 1],
         np.zeros(fft_size - half - 1)]).astype(np.float32)


def synthesize_from_streams(mgc, lf0, vuv, bap, noise, fs: int,
                            frame_period: float = 5.0,
                            vuv_threshold: float = 0.5,
                            highpass_cutoff: float = 0.0):
    """Coded streams mgc (B, T, M), lf0 (B, T, 1), vuv (B, T, 1), bap
    (B, T, A) and noise (B, T * hop) -> waveforms (B, T * hop), float32,
    on the streams' device.  The working FFT size is CheapTrick's for
    ``fs`` (2048 at 48 kHz)."""
    hop = int(fs * frame_period / 1000.0)
    fft_size = get_cheaptrick_fft_size(fs)
    if fft_size < 4 * hop:
        raise ValueError(f"fft_size {fft_size} too small for hop {hop}")
    dev = mgc.device
    Mc = torch.from_numpy(
        spectral_decode_cepstrum_basis(fs, fft_size, int(mgc.shape[-1]))).to(
            dev)
    c = torch.matmul(mgc.to(torch.float32), Mc)
    if highpass_cutoff > 0:
        c = c + torch.from_numpy(
            _highpass_cepstrum(fs, fft_size, float(highpass_cutoff))).to(dev)
    H = torch.exp(torch.fft.rfft(c, n=fft_size, dim=-1))
    ap = decode_aperiodicity(bap.to(torch.float32), fs, fft_size)
    voiced = vuv[..., 0] > vuv_threshold
    ap = torch.where(voiced[..., None], ap, ap.clamp_min(1.0 - 1e-7))
    ap = ap.clamp(0.0, 1.0)
    f0 = torch.where(voiced, torch.exp(lf0[..., 0]),
                     torch.zeros_like(lf0[..., 0]))
    return _synthesize_from_transfer(f0, H, ap, noise, fs, hop, fft_size)


def quantize_peak_norm_int16(wav, lengths):
    """Per-signal peak normalization + int16 quantization on the device;
    ``lengths`` (B,) bounds each row's peak search."""
    mask = (torch.arange(wav.shape[1], device=wav.device)[None, :]
            < lengths[:, None])
    peak = torch.where(mask, wav, torch.zeros_like(wav)).abs().amax(
        dim=1, keepdim=True)
    wav = wav / peak.clamp_min(1e-8)
    return (wav * 32767.0).clamp(-32768.0, 32767.0).to(torch.int16)
