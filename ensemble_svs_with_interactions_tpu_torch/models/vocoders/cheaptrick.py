"""Differentiable CheapTrick spectral-envelope estimator (counterpart of
``ensemble_svs_with_interactions_tpu/models/vocoders/cheaptrick.py``).

The F0-adaptive windows and cepstral lifters are host tables indexed by
the rounded per-frame F0, built in float64 and stored as float32 exactly
as the JAX package builds them; the layer keeps them on its device and
the forward is a gather, an ``rfft``, the liftering and an ``irfft``.  At
fft 4096 and F0 70-1000 Hz the three tables take about 33 MB.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["CheapTrickLayer", "source_regularization_loss"]


def _window_table(sample_rate, fft_size, f0_floor, f0_ceil):
    """(f0_ceil + 1, fft_size) pitch-adaptive Hann-like analysis windows
    of unit energy, one per integer F0 (rows below ``f0_floor`` zero)."""
    table = np.zeros((f0_ceil + 1, fft_size), dtype=np.float32)
    for f0 in range(f0_floor, f0_ceil + 1):
        half = round(1.5 * sample_rate / f0)
        base = np.arange(-half, half + 1, dtype=np.float64)
        position = base / 1.5 / sample_rate
        left = fft_size // 2 - half
        right = fft_size // 2 + half + 1
        win = np.zeros(fft_size)
        win[left:right] = 0.5 * np.cos(math.pi * position * f0) + 0.5
        win /= np.sqrt(np.sum(win * win))
        table[f0] = win
    return table


def _lifter_tables(sample_rate, fft_size, f0_floor, f0_ceil, q1=-0.15):
    """Smoothing (sinc) and compensation (q-lifter) cepstral lifters per
    integer F0, each (f0_ceil + 1, fft_size // 2 + 1)."""
    bins = fft_size // 2 + 1
    q0 = 1.0 - 2.0 * q1
    smooth = np.zeros((f0_ceil + 1, bins), dtype=np.float32)
    comp = np.zeros((f0_ceil + 1, bins), dtype=np.float32)
    quef = np.arange(1, bins, dtype=np.float64) / sample_rate
    for f0 in range(f0_floor, f0_ceil + 1):
        smooth[f0, 0] = 1.0
        smooth[f0, 1:] = np.sin(math.pi * f0 * quef) / (math.pi * f0 * quef)
        comp[f0, 0] = q0 + 2.0 * q1
        comp[f0, 1:] = q0 + 2.0 * q1 * np.cos(2.0 * math.pi * f0 * quef)
    return smooth, comp


class CheapTrickLayer:
    """Callable CheapTrick estimator over tables built once, on
    ``device``.  It has no parameters and is not an ``nn.Module``."""

    def __init__(self, sample_rate: int, hop_size: int, fft_size: int,
                 f0_floor: int = 70, f0_ceil: int = 340,
                 uv_threshold: float = 0.0, q1: float = -0.15,
                 device="cpu"):
        if fft_size <= 3.0 * sample_rate / f0_floor:
            raise ValueError(f"fft_size {fft_size} is too short for a "
                             f"{f0_floor} Hz window at {sample_rate} Hz")
        self.sample_rate = sample_rate
        self.hop_size = hop_size
        self.fft_size = fft_size
        self.f0_floor = f0_floor
        self.f0_ceil = f0_ceil
        self.uv_threshold = uv_threshold
        device = torch.device(device)
        self.windows = torch.from_numpy(_window_table(
            sample_rate, fft_size, f0_floor, f0_ceil)).to(device)
        sm, cp = _lifter_tables(sample_rate, fft_size, f0_floor, f0_ceil, q1)
        self.smoothing_lifter = torch.from_numpy(sm).to(device)
        self.compensation_lifter = torch.from_numpy(cp).to(device)

    def __call__(self, x, f0, power: bool = False, elim_0th: bool = False):
        """x (B, T) waveform, f0 (B, T') frame-rate F0 in Hz -> (B, T',
        fft_size // 2 + 1) log spectral envelopes.  Frame n is centred on
        sample n * hop (the waveform zero-padded by fft_size // 2 each
        side); unvoiced frames take the ``f0_ceil`` window; F0 rounds half
        to even."""
        n_frames = f0.shape[1]
        f = torch.where(f0 > self.uv_threshold, f0,
                        torch.full_like(f0, float(self.f0_ceil)))
        f = torch.round(f.clamp(self.f0_floor, self.f0_ceil)).long()

        half = self.fft_size // 2
        xp = torch.nn.functional.pad(x, (half, half))
        starts = torch.arange(n_frames, device=x.device) * self.hop_size
        idx = (starts[:, None]
               + torch.arange(self.fft_size, device=x.device)[None, :])
        frames = xp[:, idx.clamp(max=xp.shape[1] - 1)]

        spec = torch.fft.rfft(frames * self.windows[f], dim=-1).abs()
        if power:
            spec = spec ** 2
        bins = self.fft_size // 2 + 1
        full = torch.cat([spec, torch.flip(spec[..., 1:-1], dims=(-1,))],
                         dim=-1)
        cep = torch.fft.rfft(torch.log(full.clamp(min=1e-7)), dim=-1).real
        if elim_0th:
            cep = torch.cat([torch.zeros_like(cep[..., :1]), cep[..., 1:]],
                            dim=-1)
        cep = cep * self.smoothing_lifter[f] * self.compensation_lifter[f]
        return torch.fft.irfft(cep, dim=-1)[..., :bins]


def source_regularization_loss(layer: CheapTrickLayer, source, f0):
    """Flatness regularizer of a generated source (B, T): the mean square
    of its log envelope without the 0th cepstrum; f0 (B, T')."""
    env = layer(source, f0, elim_0th=True)
    return torch.mean(env ** 2)
