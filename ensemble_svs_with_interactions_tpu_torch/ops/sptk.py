"""Mel-cepstral analysis and its inverse (SPTK's ``mcepalpha`` /
``freqt`` / ``sp2mc`` / ``mc2sp`` / ``mc2b``): the host NumPy branch of
``ensemble_svs_with_interactions_tpu/ops/sptk.py``, which the generation
pipeline takes for its host arrays (the merlin postfilter and uncoded
WORLD features) and feature extraction for uncoded mgc and mel-cepstral
aperiodicity.

``freqt``'s frequency-warping recursion is linear in the cepstrum, so it
is a cached (order + 1, in_len) matrix built once by running the
recursion on the identity basis; a conversion is one matmul and an rfft.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def mcepalpha(fs: int) -> float:
    """All-pass constant that best approximates the mel scale at ``fs``
    (RMS error between the warped frequency axis and the mel scale, as
    pysptk's ``mcepalpha``)."""
    alpha_candidates = np.arange(0.0, 1.0, 0.001)
    n = 256
    omega = np.arange(1, n + 1) * np.pi / n
    mel = np.log(1.0 + (omega / np.pi) * (fs / 2.0) / 1000.0)
    mel = mel / mel.max()
    best_alpha, best_err = 0.0, np.inf
    for a in alpha_candidates:
        warped = np.arctan2((1 - a * a) * np.sin(omega),
                            (1 + a * a) * np.cos(omega) - 2 * a)
        warped = np.where(warped < 0, warped + 2 * np.pi, warped)
        warped = warped / warped.max()
        err = np.sum((warped - mel) ** 2)
        if err < best_err:
            best_err, best_alpha = err, a
    return float(best_alpha)


@lru_cache(maxsize=16)
def freqt_matrix(in_len: int, order: int, alpha: float) -> np.ndarray:
    """(order + 1, in_len) matrix A with freqt(c) == A @ c."""
    prev = np.zeros((order + 1, in_len))
    eye = np.eye(in_len)
    for i in reversed(range(in_len)):
        g = np.zeros_like(prev)
        g[0] = eye[i] + alpha * prev[0]
        if order >= 1:
            g[1] = (1.0 - alpha * alpha) * prev[0] + alpha * prev[1]
        for m in range(2, order + 1):
            g[m] = prev[m - 1] + alpha * (prev[m] - g[m - 1])
        prev = g
    return prev


def freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Warped cepstrum (..., order + 1) of c (..., in_len)."""
    return c @ freqt_matrix(c.shape[-1], order, float(alpha)).T


def sp2mc(powerspec: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Power spectrum (..., fftlen//2 + 1) -> mel-cepstrum (..., order + 1),
    as pysptk's ``sp2mc``: log, real cepstrum, freqt."""
    logsp = np.log(powerspec)
    c = np.fft.irfft(logsp, axis=-1)[..., : powerspec.shape[-1]].copy()
    c[..., 0] /= 2.0
    return freqt(c, order, alpha)


def mc2sp(mc: np.ndarray, alpha: float, fftlen: int) -> np.ndarray:
    """Mel-cepstrum (..., order + 1) -> power spectrum (..., fftlen//2 + 1),
    as pysptk's ``mc2sp``: inverse-warp, symmetrize, exp(2 Re(rfft))."""
    c = freqt(np.asarray(mc), fftlen // 2, -alpha).copy()
    c[..., 0] *= 2.0
    sym = np.concatenate([c, c[..., -2:0:-1]], axis=-1)
    logamp = np.real(np.fft.rfft(sym, axis=-1)) / 2.0
    return np.exp(2.0 * logamp)


def mc2b(mc: np.ndarray, alpha: float) -> np.ndarray:
    """Mel-cepstrum -> MLSA filter coefficients."""
    order = mc.shape[-1] - 1
    b = mc.copy()
    for i in reversed(range(order)):
        b[..., i] = mc[..., i] - alpha * b[..., i + 1]
    return b
