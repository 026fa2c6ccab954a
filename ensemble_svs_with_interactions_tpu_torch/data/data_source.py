"""The mel filterbank of ``ensemble_svs_with_interactions_tpu/data/
data_source.py``, a host NumPy copy: the vocoder losses
(``train/vocoder.py``) cast it to float32 and keep it on the device."""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["mel_filterbank"]


def mel_filterbank(sr: int, fft_size: int, num_mels: int = 80,
                   fmin: float = 30, fmax: Optional[float] = None
                   ) -> np.ndarray:
    """(num_mels, fft_size // 2 + 1) float64 triangular mel filterbank, no
    area normalization; ``fmax`` None (or 0) is ``sr / 2``."""
    fmax = fmax or sr / 2

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2)
    bins = np.floor((fft_size + 1) * mel_to_hz(mel_pts) / sr).astype(int)
    fb = np.zeros((num_mels, fft_size // 2 + 1))
    for m in range(1, num_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, c):
            fb[m - 1, k] = (k - lo) / (c - lo)
        for k in range(c, hi):
            fb[m - 1, k] = (hi - k) / (hi - c)
    return fb
