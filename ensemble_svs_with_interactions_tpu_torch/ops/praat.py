"""Praat-style autocorrelation pitch extraction (Boersma 1993): the port's
copy of ``ensemble_svs_with_interactions_tpu/ops/praat.py``, the
``f0_extractor: parselmouth`` option of feature extraction
(``data/data_source.WORLDAcousticSource``).

1. per-frame windowed autocorrelation of the mean-subtracted segment,
   computed via FFT and divided by the autocorrelation of the window
   itself (Boersma's correction for sampled, windowed sounds);
2. local maxima of the normalized ACF in the [1/ceiling, 1/floor] lag
   range refined by parabolic interpolation, each scored
   ``R = r(tau) - octave_cost * log2(pitch_floor * tau)``;
3. an unvoiced candidate per frame scored
   ``voicing_threshold + max(0, 2 - intensity')`` with
   ``intensity' = (local_peak/global_peak) * (1+voicing_threshold) /
   silence_threshold``;
4. Viterbi path search maximizing total candidate strength minus
   transition costs, with Praat's 0.01 s time-step normalization of the
   transition costs.

Host NumPy: F0 extraction is a data-preparation stage.
"""

from __future__ import annotations

import numpy as np

_PERIODS_PER_WINDOW = 3.0  # Praat "ac" mode (very_accurate=False)


def _normalized_frame_acf(frames: np.ndarray, window: np.ndarray, max_lag: int):
    """r_x(tau)/r_w(tau) for each row of ``frames`` (already mean-
    subtracted), Boersma eq. (9): the windowed-signal ACF divided by the
    window ACF."""
    n = frames.shape[1]
    fft_size = 1
    while fft_size < n + max_lag + 1:
        fft_size *= 2
    fw = frames * window
    spec = np.fft.rfft(fw, fft_size, axis=1)
    acf = np.fft.irfft(spec.real**2 + spec.imag**2, fft_size, axis=1)[:, : max_lag + 1]
    norm = acf[:, :1].copy()
    norm[norm <= 0] = 1.0
    acf /= norm

    wspec = np.fft.rfft(window, fft_size)
    wacf = np.fft.irfft(wspec.real**2 + wspec.imag**2, fft_size)[: max_lag + 1]
    wacf /= wacf[0]
    # the window ACF decays to ~0 at lag ~ n; keep the division sane
    wacf = np.maximum(wacf, 1e-12)
    return acf / wacf[None, :]


def sound_to_pitch_ac(
    x: np.ndarray,
    fs: int,
    time_step: float,
    pitch_floor: float,
    pitch_ceiling: float,
    voicing_threshold: float = 0.45,
    silence_threshold: float = 0.03,
    octave_cost: float = 0.01,
    octave_jump_cost: float = 0.35,
    voiced_unvoiced_cost: float = 0.14,
    max_candidates: int = 15,
    n_frames: int | None = None,
):
    """Boersma-1993 pitch track of ``x``; returns (f0, timeaxis).

    ``f0[i]`` is the pitch at time ``i * time_step`` (0 where unvoiced).
    ``time_step`` is in seconds.  When ``n_frames`` is None it follows
    the WORLD frame-count convention used across this repo so the praat
    extractor is a drop-in for dio/harvest in the data sources.
    """
    x = np.asarray(x, dtype=np.float64)
    if n_frames is None:
        hop = fs * time_step
        n_frames = int(len(x) / hop) + 1
    timeaxis = np.arange(n_frames) * time_step

    global_peak = np.abs(x - x.mean()).max() if len(x) else 0.0
    if global_peak <= 0:
        return np.zeros(n_frames), timeaxis

    win_len = int(round(_PERIODS_PER_WINDOW / pitch_floor * fs))
    win_len += win_len % 2  # even length keeps centering simple
    window = np.hanning(win_len)
    max_lag = min(int(np.ceil(fs / pitch_floor)) + 1, win_len - 2)
    min_lag = max(2, int(fs / pitch_ceiling))

    # frame extraction centered at i*time_step (zero padding at edges);
    # gathered per chunk below — a whole-track (T, win_len) f64 matrix
    # would be ~0.7 GB for a 3-minute 48 kHz track
    centers = np.round(timeaxis * fs).astype(np.int64)
    offsets = (np.arange(win_len) - win_len // 2)[None, :]

    def _gather_frames(sl):
        idx = centers[sl, None] + offsets
        valid = (idx >= 0) & (idx < len(x))
        f = np.where(valid, x[np.clip(idx, 0, len(x) - 1)], 0.0)
        return f - f.mean(axis=1, keepdims=True)

    local_peak = np.empty(n_frames)

    n_cand = max_candidates
    cand_freq = np.zeros((n_frames, n_cand))  # 0 == unvoiced candidate
    cand_str = np.full((n_frames, n_cand), -1e30)

    # normalized ACF in manageable chunks
    chunk = 2048
    for s in range(0, n_frames, chunk):
        e = min(s + chunk, n_frames)
        frames = _gather_frames(slice(s, e))
        local_peak[s:e] = np.abs(frames).max(axis=1)
        r = _normalized_frame_acf(frames, window, max_lag)
        seg = r[:, min_lag : max_lag - 1]
        is_peak = (seg > r[:, min_lag - 1 : max_lag - 2]) & (
            seg >= r[:, min_lag + 1 : max_lag]
        )
        # peak refinement + per-frame top-k, vectorized across the whole
        # chunk at only the actual local maxima (this was the last
        # per-frame Python hot loop in data prep): parabolic refinement on
        # the flat (frame, lag) peak coordinates, then a lexsort-grouped
        # rank to scatter each frame's strongest candidates into slots.
        fi, li = np.nonzero(is_peak)
        if len(fi) == 0:
            continue
        idx = li + min_lag
        rm = r[fi, idx - 1]
        r0 = r[fi, idx]
        rp = r[fi, idx + 1]
        denom = 2.0 * r0 - rm - rp
        shift = np.where(
            np.abs(denom) > 1e-30,
            0.5 * (rp - rm) / np.where(denom == 0, 1.0, denom),
            0.0,
        )
        shift = np.clip(shift, -0.5, 0.5)
        vals = r0 + 0.25 * (rp - rm) * shift
        # Boersma: reflect improbable >1 strengths back below 1
        vals = np.where(vals > 1.0, 1.0 / np.where(vals == 0, 1.0, vals), vals)
        freqs = fs / (idx + shift)
        ok = (freqs >= pitch_floor) & (freqs <= pitch_ceiling)
        fi, freqs, vals = fi[ok], freqs[ok], vals[ok]
        if len(fi) == 0:
            continue
        # R = r - octave_cost * log2(pitch_floor * tau); tau = 1/freq
        strength = vals - octave_cost * np.log2(pitch_floor / freqs)
        # strongest-first within each frame; candidate slot order is
        # irrelevant to the Viterbi pass
        order = np.lexsort((-strength, fi))
        fi_s, str_s, frq_s = fi[order], strength[order], freqs[order]
        first = np.r_[True, fi_s[1:] != fi_s[:-1]]
        group_start = np.maximum.accumulate(
            np.where(first, np.arange(len(fi_s)), 0)
        )
        rank = np.arange(len(fi_s)) - group_start
        keep = rank < n_cand - 1
        cand_freq[s + fi_s[keep], 1 + rank[keep]] = frq_s[keep]
        cand_str[s + fi_s[keep], 1 + rank[keep]] = str_s[keep]

    # unvoiced candidate (Boersma eq. 23): slot 0
    intensity = (local_peak / global_peak) * (1.0 + voicing_threshold) / max(
        silence_threshold, 1e-12
    )
    cand_str[:, 0] = voicing_threshold + np.maximum(0.0, 2.0 - intensity)

    # Viterbi path search (Boersma sec. 4; Praat Pitch_pathFinder's
    # 0.01 s time-step correction of the transition costs)
    correction = 0.01 / max(time_step, 1e-9)
    oj = octave_jump_cost * correction
    vuv = voiced_unvoiced_cost * correction

    score = cand_str[0].copy()
    back = np.zeros((n_frames, n_cand), dtype=np.int64)
    for t in range(1, n_frames):
        f_prev = cand_freq[t - 1]
        f_cur = cand_freq[t]
        prev_voiced = f_prev > 0
        cur_voiced = f_cur > 0
        trans = np.where(
            prev_voiced[:, None] & cur_voiced[None, :],
            oj
            * np.abs(
                np.log2(
                    np.maximum(f_prev, 1e-9)[:, None]
                    / np.maximum(f_cur, 1e-9)[None, :]
                )
            ),
            np.where(prev_voiced[:, None] == cur_voiced[None, :], 0.0, vuv),
        )
        total = score[:, None] - trans
        back[t] = np.argmax(total, axis=0)
        score = total[back[t], np.arange(n_cand)] + cand_str[t]

    path = np.zeros(n_frames, dtype=np.int64)
    path[-1] = int(np.argmax(score))
    for t in range(n_frames - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    f0 = cand_freq[np.arange(n_frames), path]
    return f0, timeaxis
