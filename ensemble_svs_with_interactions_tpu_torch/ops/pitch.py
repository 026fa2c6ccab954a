"""F0 helpers (counterparts in
``ensemble_svs_with_interactions_tpu/ops/pitch.py``): ``interp1d`` for the
featurizer, the zero-phase Butterworth filters of the host
postprocess, ``lowpass_filter`` (trajectory smoothing) and
``bandpass_filter`` (the waveform's 70 Hz high-pass), and the note
segmentation of the trainers' pitch regularization, ``note_segments``.
Host NumPy/SciPy."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def lowpass_filter(x: np.ndarray, fs: int, cutoff: float = 5, N: int = 5,
                   axis: int = -1):
    """Zero-phase Butterworth lowpass of order ``N`` along ``axis``;
    signals no longer than ``max(len(a), len(b)) * (N // 2 + 1)`` samples
    are returned as they are."""
    from scipy.signal import butter, filtfilt

    b, a = butter(N, float(cutoff / (fs // 2)), "lowpass")
    if x.shape[axis if axis >= 0 else x.ndim + axis] <= max(len(a), len(b)) * (
            N // 2 + 1):
        return x
    return filtfilt(b, a, x, axis=axis)


def bandpass_filter(x: np.ndarray, sr: int, cutoff: float = 70, N: int = 5):
    """Zero-phase Butterworth bandpass from ``cutoff`` Hz to 0.999 of the
    Nyquist rate."""
    from scipy.signal import butter, filtfilt

    b, a = butter(N, [cutoff / (sr // 2), 0.999], "bandpass")
    return filtfilt(b, a, x)


def interp1d(f0: np.ndarray, kind: str = "slinear") -> np.ndarray:
    """Piecewise-linear interpolation of positive F0 over gaps; edges hold
    the nearest positive value.  Accepts (T,) or (T, 1)."""
    if kind not in ("slinear", "linear"):
        raise NotImplementedError(f"interp1d kind={kind!r} is not supported")
    f0 = np.asarray(f0)
    squeeze = f0.ndim == 2
    flat = f0.reshape(-1).astype(np.float64)
    nz = np.nonzero(flat > 0)[0]
    out = flat if len(nz) == 0 else np.interp(np.arange(len(flat)), nz,
                                              flat[nz])
    out = out.astype(f0.dtype if f0.dtype.kind == "f" else np.float64)
    return out.reshape(f0.shape) if squeeze else out


def nonzero_segments(f0: np.ndarray) -> List[Tuple[int, int]]:
    """(start, end) index pairs of contiguous nonzero runs."""
    v = np.asarray(f0) > 0
    if not v.any():
        return []
    dv = np.diff(v.astype(np.int8))
    starts = list(np.where(dv == 1)[0] + 1)
    ends = list(np.where(dv == -1)[0] + 1)
    if v[0]:
        starts = [0] + starts
    if v[-1]:
        ends = ends + [len(v) - 1]
    return list(zip(starts, ends))


def note_segments(lf0_score_denorm: np.ndarray) -> List[Tuple[int, int]]:
    """Note (start, end) indices from a denormalized score log-F0 track: a
    new note starts wherever the (nonzero) score pitch changes value."""
    x = np.asarray(lf0_score_denorm)
    segments = []
    for s, e in nonzero_segments(x):
        seg = x[s: e + 1]
        change = np.where(np.abs(np.diff(seg)) > 0)[0]
        note_start = s
        for pos in change:
            note_end = s + int(pos)
            segments.append((note_start, note_end))
            note_start = note_end + 1
        if note_start < e:
            segments.append((note_start, e))
    return segments
