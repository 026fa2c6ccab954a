"""F0 helpers (counterparts in
``ensemble_svs_with_interactions_tpu/ops/pitch.py``): ``interp1d`` for the
featurizer, the zero-phase Butterworth filters of the host
postprocess, ``lowpass_filter`` (trajectory smoothing) and
``bandpass_filter`` (the waveform's 70 Hz high-pass), the note
segmentation of the trainers' pitch regularization, ``note_segments``,
and what feature extraction calls: cents, the score-based F0
correction, smoothed F0 and the vibrato extractors, and the sine
vibrato re-synthesis of the host postprocess (``gen_sine_vibrato``).
Host NumPy/SciPy."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_C4_HZ = 440.0 * 2 ** (3 / 12 - 1)
_C4_CENT = 4800.0


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


def hz_to_cent_based_c4(hz: np.ndarray) -> np.ndarray:
    out = hz.copy()
    nz = np.where(hz > 0)[0]
    out[nz] = 1200.0 * np.log(hz[nz] / _C4_HZ) / np.log(2) + _C4_CENT
    return out


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


def compute_f0_correction_ratio(
    f0: np.ndarray,
    f0_score: np.ndarray,
    edges_to_be_excluded: int = 50,
    out_of_tune_threshold: float = 200.0,
    correction_threshold: float = 100.0,
) -> float:
    """Global pitch-correction ratio so extracted F0 matches the score.

    Note centers (excluding overshoot-prone edges) vote on the ratio;
    out-of-tune frames beyond 2 semitones are excluded, and the final
    correction is clipped to +/- 1 semitone.
    """
    segments = note_segments(f0_score)
    center_f0s, center_scores = [], []
    for s, e in segments:
        if e - s > edges_to_be_excluded * 2:
            center_f0s.append(f0[s + edges_to_be_excluded : e - edges_to_be_excluded])
            center_scores.append(
                f0_score[s + edges_to_be_excluded : e - edges_to_be_excluded]
            )
    if not center_f0s:
        return 1.0
    center_f0s = np.concatenate(center_f0s)
    center_scores = np.concatenate(center_scores)
    nz = (center_f0s > 0) & (center_scores > 0)
    if not nz.any():
        return 1.0
    ratio = center_scores[nz] / center_f0s[nz]
    hi = np.exp(out_of_tune_threshold * np.log(2) / 1200)
    lo = np.exp(-out_of_tune_threshold * np.log(2) / 1200)
    ratio = ratio[(ratio < hi) & (ratio > lo)]
    if len(ratio) == 0:
        return 1.0
    offset = float(ratio.mean())
    hi = np.exp(correction_threshold * np.log(2) / 1200)
    lo = np.exp(-correction_threshold * np.log(2) / 1200)
    return float(np.clip(offset, lo, hi))


def extract_smoothed_f0(f0: np.ndarray, sr: int, cutoff: float = 8) -> np.ndarray:
    """Low-pass filter F0 within each voiced segment."""
    out = f0.copy()
    for s, e in nonzero_segments(f0):
        out[s:e] = lowpass_filter(f0[s:e], sr, cutoff=cutoff)
    return out


def extract_smoothed_continuous_f0(
    f0: np.ndarray, sr: int, cutoff: float = 20
) -> np.ndarray:
    """Low-pass filter a continuous (interpolated) F0/log-F0 track."""
    is_2d = f0.ndim == 2
    flat = f0.reshape(-1)
    smooth = lowpass_filter(flat, sr, cutoff=cutoff)
    next_cutoff = 50
    while (smooth < 0).any() and next_cutoff < sr // 2:
        smooth = lowpass_filter(flat, sr, cutoff=next_cutoff)
        next_cutoff *= 2
    return smooth.reshape(f0.shape) if is_2d else smooth


def extract_vibrato_likelihood(
    f0_smooth: np.ndarray,
    sr: int,
    win_length: int = 32,
    n_fft: int = 128,
    min_freq: float = 3,
    max_freq: float = 8,
) -> np.ndarray:
    """Frame-wise vibrato likelihood from the STFT of the F0 derivative."""
    from scipy.signal import stft

    df0 = np.diff(f0_smooth)
    # hop=1 STFT of the f0 derivative (scipy returns (freq, time))
    _, _, Z = stft(
        df0,
        nperseg=win_length,
        noverlap=win_length - 1,
        nfft=n_fft,
        window="hann",
        boundary="zeros",
        padded=True,
    )
    X = np.abs(Z)
    X_norm = X / (X.sum(0) + 1e-7)
    freq_per_bin = sr / n_fft
    lo = int(min_freq / freq_per_bin)
    hi = int(max_freq / freq_per_bin)
    St = np.abs(np.diff(X_norm, axis=0)).sum(0)
    Ft = X_norm[lo:hi, :].sum(0)
    like = St * Ft
    # align to the f0 length
    if len(like) >= len(f0_smooth):
        like = like[: len(f0_smooth)]
    else:
        like = np.pad(like, (0, len(f0_smooth) - len(like)))
    return like


def _vibrato_params_for_segment(pitch_seg: np.ndarray, sr: int):
    """Per-frame vibrato rate (m_f, Hz) and extent (m_a) tracks for one
    vibrato segment, via the peak-pair method (Nakano et al. 2006; the
    reference computes the same quantities per peak/trough pair,
    nnsvs/pitch.py:190-250).

    Merged-extrema formulation: let p_0 < p_1 < ... < p_{n-1} be the
    strictly alternating extrema positions (peaks at even indices; a
    valid vibrato segment starts and ends on a peak).  Then
      * rate at p_i      = sr / (p_{i+2} - p_i)  — one full cycle spans
        two same-type extrema — for i <= n-3;
      * extent at an interior extremum p_i = half the distance between
        its pitch and the mean of its two neighbors:
        0.5 * |x[p_i] - (x[p_{i-1}] + x[p_{i+1}]) / 2|.
    Frames without an extremum keep 0 (interpolated by the caller).
    """
    from scipy.signal import argrelmax, argrelmin

    hi_pos = argrelmax(pitch_seg)[0]
    lo_pos = argrelmin(pitch_seg)[0]
    if len(hi_pos) != len(lo_pos) + 1:
        return None, None
    pos = np.empty(len(hi_pos) + len(lo_pos), dtype=int)
    pos[0::2] = hi_pos
    pos[1::2] = lo_pos
    if len(pos) < 3 or (np.diff(pos) <= 0).any():
        return None, None

    m_f = np.zeros(len(pitch_seg))
    m_a = np.zeros(len(pitch_seg))
    m_f[pos[:-2]] = sr / (pos[2:] - pos[:-2])
    x = pitch_seg[pos]
    m_a[pos[1:-1]] = 0.5 * np.abs(x[1:-1] - 0.5 * (x[:-2] + x[2:]))
    return m_a, m_f


def _interp_sparse(v: np.ndarray) -> np.ndarray:
    nz = np.where(v > 0)[0]
    idx = np.unique(np.concatenate([[0], nz, [len(v) - 1]]))
    return np.interp(np.arange(len(v)), idx, v[idx])


def _segment_extent(pitch_seg: np.ndarray) -> np.ndarray:
    from scipy.signal import argrelmax, argrelmin

    hi_pos = argrelmax(pitch_seg)[0]
    lo_pos = argrelmin(pitch_seg)[0]
    if len(hi_pos) <= 1 or len(lo_pos) <= 1:
        return np.array([-1.0])
    if len(hi_pos) < len(lo_pos):
        lo_pos = lo_pos[:-2]
    elif len(hi_pos) == len(lo_pos):
        lo_pos = lo_pos[:-1]
    if len(hi_pos) != len(lo_pos) + 1:
        return np.array([-1.0])
    hi_p, lo_p = pitch_seg[hi_pos], pitch_seg[lo_pos]
    E = np.zeros(len(hi_pos) - 1 + len(lo_pos) - 1)
    E[0::2] = (hi_p[1:] + hi_p[:-1]) / 2 - lo_p
    E[1::2] = hi_p[1:-1] - (lo_p[1:] + lo_p[:-1]) / 2
    return E


def extract_vibrato_parameters(
    pitch: np.ndarray,
    vibrato_likelihood: np.ndarray,
    sr: int = 200,
    threshold: float = 0.12,
    min_cross_count: int = 5,
    min_extent: float = 30,
    max_extent: float = 150,
    interp_params: bool = True,
    clip_extent: bool = True,
):
    """Detect vibrato sections and extract per-frame rate/extent tracks.

    pitch is the smoothed F0 in cents (zeros = unvoiced).  Returns
    (vibrato_flags, m_a [cent], m_f [Hz]).  Detection: likelihood-gated
    candidate peaks expanded within each voiced segment while the
    oscillation satisfies cross-count and extent constraints.
    """
    T = len(pitch)
    flags = np.zeros(T, dtype=int)
    m_a = np.zeros(T)
    m_f = np.zeros(T)

    for s, e in nonzero_segments(pitch):
        # nonzero_segments ends are EXCLUSIVE for interior runs (first zero
        # index) but inclusive for a run touching the signal end — slice so
        # no 0-cent unvoiced frame leaks into the vibrato statistics
        e_excl = e + 1 if pitch[e] > 0 else e
        seg = pitch[s:e_excl]
        if len(seg) < 4 * min_cross_count:
            continue
        like = vibrato_likelihood[s:e_excl]
        if (like > threshold).sum() == 0:
            continue
        # candidate: the whole voiced segment trimmed to the likelihood span
        cand = np.where(like > threshold)[0]
        c0, c1 = int(cand[0]), int(cand[-1]) + 1
        if c1 - c0 < 3 * min_cross_count:
            continue
        sub = seg[c0:c1]
        m = sub.mean()
        cross = int(np.sum(np.abs(np.diff(np.sign(sub - m))) > 0))
        E = _segment_extent(sub)
        if (E <= 0).any():
            continue
        extent = 0.5 * E.mean()
        if (
            cross < min_cross_count
            or extent < min_extent
            or extent > max_extent
            or ((0.5 * E) > max_extent * 2).any()
        ):
            continue
        ma_seg, mf_seg = _vibrato_params_for_segment(sub, sr)
        if ma_seg is None:
            continue
        if interp_params:
            ma_seg = _interp_sparse(ma_seg)
            mf_seg = np.clip(_interp_sparse(mf_seg), 3, 8)
        if clip_extent:
            ma_seg = np.clip(ma_seg, min_extent, max_extent)
        flags[s + c0 : s + c1] = 1
        m_a[s + c0 : s + c1] = ma_seg
        m_f[s + c0 : s + c1] = mf_seg
    return flags, m_a, m_f


def gen_sine_vibrato(f0: np.ndarray, sr: int, m_a: np.ndarray,
                     m_f: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Re-synthesize vibrato as sinusoidal modulation of F0: amplitude
    ``m_a`` (cents, clipped to 30-150) and rate ``m_f`` (Hz, clipped to
    3-8) over each run where ``m_a`` is nonzero, then a 12 Hz low-pass up
    to the end of the voiced run it lies in."""
    out = f0.copy()
    voiced_ends = np.asarray([e for _, e in nonzero_segments(f0)])
    for s, e in nonzero_segments(m_a):
        mf_seg = np.clip(m_f[s:e], 3, 8)
        ma_seg = np.clip(m_a[s:e], 30, 150)
        cent = scale * ma_seg * np.sin(2 * np.pi / sr * mf_seg
                                       * np.arange(e - s))
        out[s:e] = f0[s:e] * np.exp(cent * np.log(2) / 1200)
        nxt = voiced_ends[voiced_ends > e]
        if len(nxt) > 0:
            ve = int(nxt[0])
            out[s:ve] = lowpass_filter(out[s:ve], sr, cutoff=12)
    return out
