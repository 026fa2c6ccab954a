"""WORLD-style speech analysis (host NumPy, vectorized across frames): the
port's copy of ``ensemble_svs_with_interactions_tpu/ops/world/analysis.py``.

The feature extraction of the recipe's stage 1 (``data/data_source.py``'s
``WORLDAcousticSource``) calls it at data-preparation time on the host,
as the JAX package does; nothing here runs on the card.  Where the native
library builds (``native/``) the per-frame loops run in its C++, else in
NumPy; the two paths agree within ``tests/test_native.py``'s tolerances.

Implementations:
  * ``dio``/``harvest``: normalized-autocorrelation F0 estimation with
    parabolic lag refinement, octave-error median correction and voicing
    decision (``harvest`` adds interval candidates and contour fixing).
  * ``stonemask``: harmonic instantaneous-frequency refinement of F0.
  * ``cheaptrick``: pitch-adaptive Hanning windowing, DC correction,
    rectangular spectral smoothing (width 2f0/3) and cepstral liftering
    with the q1=-0.15 recovery lifter.
  * ``d4c``: band aperiodicity via comb cancellation per 3 kHz band, with
    a LoveTrain-style global periodicity gate (``threshold``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.ndimage import median_filter

from ensemble_svs_with_interactions_tpu_torch.ops.world.codec import (
    FREQUENCY_INTERVAL,
    decode_aperiodicity_np,
    get_cheaptrick_fft_size,
    get_num_aperiodicities,
)
from ensemble_svs_with_interactions_tpu_torch import native

def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0

DEFAULT_F0 = 500.0  # WORLD's kDefaultF0 for unvoiced spectral analysis
_EPS = 1e-12

# Empirical calibration of the white-noise envelope level after windowing,
# DC correction and liftering (see tests/test_world.py copy-synthesis).
NOISE_CALIBRATION = 1.06
# The harmonic-path envelope integral is inflated by ~1.73/1.06 relative to
# the noise path by the smoothing+liftering chain; synthesis compensates in
# the pulse amplitude (synthesis.PULSE_CALIBRATION).


def _frame_positions(n_samples: int, fs: int, frame_period: float) -> np.ndarray:
    hop = fs * frame_period / 1000.0
    n_frames = int(n_samples / hop) + 1
    return np.arange(n_frames) * frame_period / 1000.0


def _gather_frames(x: np.ndarray, centers: np.ndarray, length: int) -> np.ndarray:
    """(T, length) windows of x centered at given sample positions;
    out-of-range samples are zeroed (not edge-replicated)."""
    half = length // 2
    idx = centers[:, None] + np.arange(-half, length - half)[None, :]
    out = x[np.clip(idx, 0, len(x) - 1)]
    return np.where((idx >= 0) & (idx < len(x)), out, 0.0)


# --------------------------------------------------------------------------
# F0 estimation
# --------------------------------------------------------------------------


def _nccf_candidates(
    x: np.ndarray,
    fs: int,
    centers: np.ndarray,
    f0_floor: float,
    f0_ceil: float,
    n_candidates: int,
):
    """Top-K NCCF peaks per frame with parabolic lag refinement.

    Returns (f0_cand (T, K), score (T, K), energy (T,)); missing
    candidates have score 0 and f0 = f0_floor.
    """
    if native.available():
        return native.nccf(x, centers, fs, f0_floor, f0_ceil, n_candidates)
    max_lag = int(fs / f0_floor)
    win_len = int(2 ** np.ceil(np.log2(2 * max_lag + 1)))
    frames = _gather_frames(x, centers, win_len)
    frames = frames - frames.mean(axis=1, keepdims=True)

    spec = np.fft.rfft(frames, n=2 * win_len, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), axis=1)[:, : max_lag + 1]
    r0 = np.maximum(ac[:, 0], _EPS)
    nccf = ac / r0[:, None]

    min_lag = max(2, int(fs / f0_ceil))
    region = nccf[:, min_lag : max_lag + 1]

    # local maxima mask (strictly above left, >= right)
    left = np.pad(region[:, :-1], ((0, 0), (1, 0)), constant_values=-np.inf)
    right = np.pad(region[:, 1:], ((0, 0), (0, 1)), constant_values=-np.inf)
    is_peak = (region > left) & (region >= right)
    peak_scores = np.where(is_peak, region, -np.inf)

    T = region.shape[0]
    K = n_candidates
    order = np.argsort(peak_scores, axis=1)[:, ::-1][:, :K]  # best-first
    score = np.take_along_axis(peak_scores, order, axis=1)
    lag = order + min_lag

    # parabolic interpolation per candidate
    li = np.clip(lag, min_lag + 1, max_lag - 1)
    rows = np.arange(T)[:, None]
    ym1 = nccf[rows, li - 1]
    y0 = nccf[rows, li]
    yp1 = nccf[rows, li + 1]
    denom = ym1 - 2 * y0 + yp1
    delta = np.where(np.abs(denom) > _EPS, 0.5 * (ym1 - yp1) / denom, 0.0)
    lag_refined = li + np.clip(delta, -1.0, 1.0)

    f0_cand = fs / lag_refined
    valid = np.isfinite(score)
    score = np.where(valid, score, 0.0)
    f0_cand = np.where(valid, f0_cand, f0_floor)
    return f0_cand, np.clip(score, 0.0, 1.0), r0 / win_len


def _viterbi_track(
    f0_cand: np.ndarray,
    score: np.ndarray,
    voicing_threshold: float,
    octave_cost: float = 0.35,
    vuv_cost: float = 0.14,
):
    """RAPT-style dynamic-programming pitch tracking.

    States per frame: K voiced candidates + 1 unvoiced.  Local cost is
    ``1 - score`` for voiced and ``1 - voicing_threshold`` for unvoiced
    (so unvoiced wins when every candidate correlates worse than the
    threshold — a HIGHER threshold makes more frames unvoiced);
    transitions pay ``octave_cost`` per octave of pitch jump and
    ``vuv_cost`` for voicing flips.  Returns f0 with 0 at unvoiced.
    """
    T, K = f0_cand.shape
    lf0 = np.log2(np.maximum(f0_cand, _EPS))
    local = np.concatenate(
        [1.0 - score, np.full((T, 1), 1.0 - voicing_threshold)], axis=1
    )

    cost = local[0].copy()
    back = np.zeros((T, K + 1), np.int32)
    for t in range(1, T):
        # voiced->voiced transition matrix (K+1, K+1): octave distance
        d = np.abs(lf0[t - 1][:, None] - lf0[t][None, :]) * octave_cost
        trans = np.empty((K + 1, K + 1))
        trans[:K, :K] = d
        trans[K, :K] = vuv_cost  # unvoiced -> voiced
        trans[:K, K] = vuv_cost  # voiced -> unvoiced
        trans[K, K] = 0.0
        total = cost[:, None] + trans
        back[t] = np.argmin(total, axis=0)
        cost = total[back[t], np.arange(K + 1)] + local[t]

    path = np.zeros(T, np.int32)
    path[-1] = int(np.argmin(cost))
    for t in range(T - 1, 0, -1):
        path[t - 1] = back[t, path[t]]

    voiced = path < K
    f0 = np.where(voiced, f0_cand[np.arange(T), np.minimum(path, K - 1)], 0.0)
    return f0


def dio(
    x: np.ndarray,
    fs: int,
    frame_period: float = 5.0,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    voicing_threshold: float = 0.55,
    n_candidates: int = 5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Estimate F0 with normalized autocorrelation + Viterbi tracking.

    Top-``n_candidates`` NCCF peaks per frame feed a RAPT-style DP that
    trades correlation strength against pitch-jump and voicing-flip
    costs — the contour-selection role of WORLD's dio/harvest candidate
    connection, redesigned around a vectorized NCCF front end.

    Returns (f0, temporal_positions); f0 is 0 at unvoiced frames.
    """
    x = np.asarray(x, dtype=np.float64)
    t = _frame_positions(len(x), fs, frame_period)
    centers = np.rint(t * fs).astype(np.int64)

    f0_cand, score, energy = _nccf_candidates(
        x, fs, centers, f0_floor, f0_ceil, n_candidates
    )
    score = np.where(energy[:, None] > 1e-8, score, 0.0)
    f0 = _viterbi_track(f0_cand, score, voicing_threshold)

    # residual octave-error suppression: median filter on voiced log-f0
    lf0 = np.where(f0 > 0, np.log(np.maximum(f0, _EPS)), 0.0)
    med = median_filter(lf0, size=5, mode="nearest")
    bad = (f0 > 0) & (np.abs(lf0 - med) > np.log(1.8)) & (med > 0)
    f0 = np.where(bad, np.exp(med), f0)
    f0 = np.where((f0 >= f0_floor) & (f0 <= f0_ceil), f0, 0.0)
    return f0, t


def _interval_candidates(
    x: np.ndarray,
    fs: int,
    centers: np.ndarray,
    f0_floor: float,
    f0_ceil: float,
    channels_per_octave: float = 2.0,
):
    """Harvest-style candidate-interval F0 estimates (WORLD harvest.cpp's
    GetRawF0Candidates redesigned vectorized).

    For each log-spaced boundary frequency the signal is band-limited by a
    smooth FFT low-pass (DC blocked); four event-interval tracks — rising
    and falling zero crossings, peaks and dips (zero crossings of the
    derivative) — each yield an instantaneous-F0 track.  Where the four
    agree the channel contributes a candidate whose score falls with the
    relative deviation between the four estimates.  Unlike the NCCF front
    end, this keeps recall on irregular glottal excitation (creak /
    diplophonia, strong amplitude jitter): the band-limited fundamental
    still crosses zero regularly when fine-structure correlation at one
    period has collapsed.

    Returns (cand (T, C), score (T, C)); empty channels score 0.
    """
    T = len(centers)
    t_frames = centers / fs
    n_oct = np.log2(f0_ceil / f0_floor)
    n_ch = max(1, int(np.ceil(n_oct * channels_per_octave)) + 1)
    bfs = f0_floor * 2.0 ** (np.arange(1, n_ch + 1) / channels_per_octave)

    nfft = 1 << int(np.ceil(np.log2(max(len(x), 2))))
    X = np.fft.rfft(x, nfft)
    freqs = np.arange(len(X)) * fs / nfft
    global_peak = max(np.abs(x).max(), _EPS)

    cands = np.zeros((T, n_ch))
    scores = np.zeros((T, n_ch))
    from scipy.ndimage import maximum_filter1d

    for ci, bf in enumerate(bfs):
        # raised-cosine low-pass: unity below 0.7*bf, zero above 1.6*bf,
        # with a DC-blocking ramp below half the floor
        tr = np.clip((freqs - 0.7 * bf) / (0.9 * bf), 0.0, 1.0)
        H = 0.5 + 0.5 * np.cos(np.pi * tr)
        H *= np.clip(freqs / (0.5 * f0_floor), 0.0, 1.0)
        y = np.fft.irfft(X * H, nfft)[: len(x)]
        dy = np.diff(y, append=y[-1])

        ests = np.full((T, 4), np.nan)
        t_lo, t_hi = np.inf, -np.inf
        for ei, sig in enumerate((y, -y, dy, -dy)):
            rises = np.where((sig[:-1] < 0) & (sig[1:] >= 0))[0]
            if len(rises) < 3:
                continue
            denom = sig[rises + 1] - sig[rises]
            frac = np.where(np.abs(denom) > _EPS, -sig[rises] / denom, 0.5)
            tz = (rises + frac) / fs
            f = 1.0 / np.maximum(np.diff(tz), _EPS)
            tm = 0.5 * (tz[1:] + tz[:-1])
            ests[:, ei] = np.interp(t_frames, tm, f)
            t_lo, t_hi = min(t_lo, tm[0]), max(t_hi, tm[-1])

        if np.isnan(ests).any():
            continue
        mean = ests.mean(axis=1)
        dev = np.sqrt(((ests - mean[:, None]) ** 2).mean(axis=1)) / np.maximum(
            mean, _EPS
        )
        score = np.clip(1.0 - 12.0 * dev, 0.0, 1.0)
        # a channel only sees its own fundamental: estimates far from the
        # band edge are aliases of harmonics / subharmonic mixtures
        ok = (
            (mean >= max(f0_floor, bf / 3.0))
            & (mean <= min(f0_ceil, 1.2 * bf))
            & (t_frames >= t_lo)
            & (t_frames <= t_hi)
        )
        # amplitude gate: the band-limited component must carry real energy
        env = maximum_filter1d(np.abs(y), size=max(3, int(fs / bf)))
        amp = env[np.clip(centers, 0, len(y) - 1)]
        ok &= amp > 5e-3 * global_peak
        cands[:, ci] = np.where(ok, mean, f0_floor)
        scores[:, ci] = np.where(ok, score, 0.0)
    return cands, scores


def harvest(
    x, fs, frame_period: float = 5.0, f0_floor: float = 71.0, f0_ceil: float = 800.0
):
    """Harvest-style F0 estimation: higher recall than :func:`dio` plus
    refined contours.

    Mirrors the structure of WORLD's Harvest:
      1. TWO candidate sources feed one DP tracker with a LAX voicing
         gate (Harvest favors recall): the NCCF front end shared with
         :func:`dio`, plus Harvest's candidate-interval estimates
         (:func:`_interval_candidates` — per-channel zero-crossing/peak/
         dip interval consistency, the machinery that keeps recall on
         creak/diplophonia where one-period correlation collapses);
      2. per-frame instantaneous-frequency refinement of the selected
         contour (Harvest's GetRefinedF0);
      3. contour fixing: short unvoiced gaps (< 50 ms) between voiced
         regions whose endpoints agree within one semitone are bridged by
         log-linear interpolation (Harvest's FixF0Contour connection step).
    """
    x = np.asarray(x, dtype=np.float64)
    t = _frame_positions(len(x), fs, frame_period)
    centers = np.rint(t * fs).astype(np.int64)

    f0_cand, score, energy = _nccf_candidates(
        x, fs, centers, f0_floor, f0_ceil, 5
    )
    icand, iscore = _interval_candidates(x, fs, centers, f0_floor, f0_ceil)
    f0_cand = np.concatenate([f0_cand, icand], axis=1)
    score = np.concatenate([score, iscore], axis=1)
    score = np.where(energy[:, None] > 1e-8, score, 0.0)
    f0 = _viterbi_track(f0_cand, score, voicing_threshold=0.45)

    # residual octave-error suppression (same post-pass as dio)
    lf0 = np.where(f0 > 0, np.log(np.maximum(f0, _EPS)), 0.0)
    med = median_filter(lf0, size=5, mode="nearest")
    bad = (f0 > 0) & (np.abs(lf0 - med) > np.log(1.8)) & (med > 0)
    f0 = np.where(bad, np.exp(med), f0)
    f0 = np.where((f0 >= f0_floor) & (f0 <= f0_ceil), f0, 0.0)
    voiced = f0 > 0
    if voiced.any():
        est = _refine_f0_if(x, np.where(voiced, f0, DEFAULT_F0), centers, fs)
        f0 = np.where(voiced, est, 0.0)

    # ---- contour fixing: bridge short, consistent unvoiced gaps ----------
    max_gap = max(1, int(round(50.0 / frame_period)))  # 50 ms
    v = f0 > 0
    idx = np.where(v)[0]
    if len(idx) >= 2:
        gaps = np.where(np.diff(idx) > 1)[0]
        for g in gaps:
            a, b = idx[g], idx[g + 1]
            if (b - a - 1) <= max_gap and abs(
                np.log2(f0[b] / f0[a])
            ) <= 1.0 / 12.0:
                span = np.arange(a + 1, b)
                f0[span] = np.exp(
                    np.interp(span, [a, b], np.log([f0[a], f0[b]]))
                )
    f0 = np.where((f0 >= f0_floor) & (f0 <= f0_ceil), f0, 0.0)
    return f0, t


def _refine_f0_if(
    x: np.ndarray,
    est: np.ndarray,
    centers: np.ndarray,
    fs: int,
    periods: float = 6.0,
    n_harm: int = 6,
    iters: int = 2,
) -> np.ndarray:
    """Instantaneous-frequency F0 refinement (shared by stonemask/harvest).

    The IF at each harmonic bin is the cross-spectrum phase advance of two
    DFTs one sample apart; the refined F0 is the power-weighted mean of
    IF/k over the first ``n_harm`` harmonics.  A ``periods``-long window
    keeps adjacent-harmonic leakage out of the mainlobe (3-period windows
    leave ~1.5 Hz frame-to-frame jitter at 440 Hz; 6 periods + iteration
    leave < 0.1 Hz, below synthesis phase-modulation audibility).
    """
    if native.available():
        return native.refine_if(x, est, centers, fs, periods, n_harm, iters)
    for _ in range(iters):
        win_len_f = periods * fs / est
        max_len = int(2 ** np.ceil(np.log2(win_len_f.max() + 2)))
        seg0 = _gather_frames(x, centers, max_len)
        seg1 = _gather_frames(x, centers + 1, max_len)
        offs = np.arange(max_len) - max_len // 2
        rel = offs[None, :] / (win_len_f[:, None] / 2.0)
        win = np.where(np.abs(rel) <= 1.0, 0.5 + 0.5 * np.cos(np.pi * rel), 0.0)
        S0 = np.fft.rfft(seg0 * win, axis=1)
        S1 = np.fft.rfft(seg1 * win, axis=1)
        inst_cycles = np.angle(np.conj(S0) * S1) / (2 * np.pi) * fs

        num = np.zeros(len(est))
        den = np.zeros(len(est))
        freq_per_bin = fs / max_len
        rows = np.arange(len(est))
        for k in range(1, n_harm + 1):
            bins = np.clip(
                np.rint(k * est / freq_per_bin).astype(np.int64),
                0,
                S0.shape[1] - 1,
            )
            power = np.abs(S0[rows, bins]) ** 2
            inst = inst_cycles[rows, bins] / k
            ok = (inst > 0) & np.isfinite(inst) & (k * est < 0.95 * fs / 2)
            num += np.where(ok, power * inst, 0.0)
            den += np.where(ok, power, 0.0)
        refined = np.where(den > _EPS, num / np.maximum(den, _EPS), est)
        good = np.abs(refined - est) / est < 0.2
        est = np.where(good, refined, est)
    return est


def stonemask(x: np.ndarray, f0: np.ndarray, temporal_positions, fs: int):
    """Refine F0 using harmonic instantaneous frequencies (pyworld
    stonemask's role; estimator described in :func:`_refine_f0_if`)."""
    x = np.asarray(x, dtype=np.float64)
    t = np.asarray(temporal_positions)
    f0 = np.asarray(f0, dtype=np.float64)
    voiced = f0 > 0
    if not voiced.any():
        return f0.copy()
    centers = np.rint(t * fs).astype(np.int64)
    est = _refine_f0_if(x, np.where(voiced, f0, DEFAULT_F0), centers, fs)
    return np.where(voiced, est, 0.0)


# --------------------------------------------------------------------------
# CheapTrick spectral envelope
# --------------------------------------------------------------------------


def cheaptrick(
    x: np.ndarray,
    f0: np.ndarray,
    temporal_positions,
    fs: int,
    q1: float = -0.15,
    f0_floor: Optional[float] = None,
    fft_size: Optional[int] = None,
):
    """CheapTrick power spectral envelope, (T, fft_size//2+1)."""
    x = np.asarray(x, dtype=np.float64)
    f0 = np.asarray(f0, dtype=np.float64)
    t = np.asarray(temporal_positions)
    if fft_size is None:
        fft_size = get_cheaptrick_fft_size(fs, f0_floor or 71.0)
    half = fft_size // 2
    centers = np.rint(t * fs).astype(np.int64)

    f0_safe = np.where(f0 > 0, f0, DEFAULT_F0)
    # lowest F0 CheapTrick can analyze with this FFT size
    f0_safe = np.maximum(f0_safe, 3.0 * fs / (fft_size - 3.0))

    if native.available() and _is_pow2(fft_size):
        return native.cheaptrick(
            x, f0_safe, centers, fs, fft_size, q1, NOISE_CALIBRATION
        )

    # ---- 1. pitch-adaptive windowed waveform -----------------------------
    half_win_f = 1.5 * fs / f0_safe
    seg = _gather_frames(x, centers, fft_size)
    offs = np.arange(fft_size) - fft_size // 2
    rel = offs[None, :] / half_win_f[:, None]
    win = np.where(np.abs(rel) <= 1.0, 0.5 + 0.5 * np.cos(np.pi * rel), 0.0)
    wsum = win.sum(axis=1, keepdims=True)
    wave = seg * win
    # remove window-weighted DC
    wave = wave - win * (wave.sum(axis=1, keepdims=True) / np.maximum(wsum, _EPS))

    # ---- 2. power spectrum with DC correction ----------------------------
    # Normalize by the window energy so the envelope of white noise equals
    # its variance (PSD semantics); the residual noise-path factor and the
    # harmonic-path inflation are calibrated constants shared with
    # synthesis.py (measured by the copy-synthesis invariance tests).
    w2sum = np.maximum((win**2).sum(axis=1, keepdims=True), _EPS)
    ps = np.abs(np.fft.rfft(wave, n=fft_size, axis=1)) ** 2 / w2sum
    ps = ps / NOISE_CALIBRATION
    freq_per_bin = fs / fft_size
    f0_bin = (f0_safe / freq_per_bin)
    # mirror-add components below f0 (compensates windowing loss at DC)
    bin_idx = np.arange(half + 1)
    mirror = np.rint(2 * f0_bin[:, None] - bin_idx[None, :]).astype(np.int64)
    mirror = np.clip(mirror, 0, half)
    below = bin_idx[None, :] < f0_bin[:, None]
    ps = ps + np.where(below, np.take_along_axis(ps, mirror, axis=1), 0.0)

    # ---- 3. rectangular smoothing, width 2 f0 / 3 -------------------------
    width_bins = (2.0 * f0_safe / 3.0) / freq_per_bin  # (T,)
    # integrate with reflected boundaries to avoid edge bias
    ext = np.concatenate([ps[:, 1:2], ps, ps[:, half - 1 : half]], axis=1)
    cum = np.cumsum(ext, axis=1)  # piecewise-constant integral, bin units

    def interp_cum(pos):
        # pos: (T, half+1) fractional positions into cum
        p = np.clip(pos, 0.0, cum.shape[1] - 1.0)
        i0 = np.floor(p).astype(np.int64)
        i1 = np.minimum(i0 + 1, cum.shape[1] - 1)
        w = p - i0
        return (
            np.take_along_axis(cum, i0, axis=1) * (1 - w)
            + np.take_along_axis(cum, i1, axis=1) * w
        )

    center_pos = bin_idx[None, :] + 1.0  # +1 for the left reflection pad
    hi = interp_cum(center_pos + width_bins[:, None] / 2.0)
    lo = interp_cum(center_pos - width_bins[:, None] / 2.0)
    smoothed = (hi - lo) / width_bins[:, None]
    smoothed = np.maximum(smoothed, _EPS)

    # ---- 4. cepstral liftering with spectral recovery ---------------------
    log_s = np.log(smoothed)
    cep = np.fft.irfft(log_s, n=fft_size, axis=1)  # (T, fft)
    quef = np.arange(fft_size)
    quef = np.minimum(quef, fft_size - quef) / fs  # symmetric quefrency (s)
    arg = np.pi * f0_safe[:, None] * quef[None, :]
    smoothing_lifter = np.where(arg < _EPS, 1.0, np.sin(arg) / np.maximum(arg, _EPS))
    compensation_lifter = (1.0 - 2.0 * q1) + 2.0 * q1 * np.cos(2.0 * arg)
    cep = cep * smoothing_lifter * compensation_lifter
    env = np.exp(np.real(np.fft.rfft(cep, n=fft_size, axis=1)))
    return env


# --------------------------------------------------------------------------
# D4C band aperiodicity
# --------------------------------------------------------------------------


def d4c(
    x: np.ndarray,
    f0: np.ndarray,
    temporal_positions,
    fs: int,
    threshold: float = 0.85,
    fft_size: Optional[int] = None,
):
    """Band aperiodicity, (T, fft_size//2+1), linear amplitude ratio [0, 1].

    Comb-cancellation estimator: around each frame, the periodic component
    is predicted as the mean of the waveform delayed/advanced by +-1 and
    +-2 exact pitch periods (fractional delays applied as phase ramps in
    the frequency domain of a long centered segment, so the cancellation
    is exact for stationary harmonics at ANY f0/fs — no window-leakage
    floor).  The comb residual contains only the aperiodic part (white
    noise passes with a known power gain of 1 + 1/K); the per-3kHz-band
    aperiodicity is sqrt(residual band power / (gain * total band power)).
    Frames whose periodicity (normalized autocorrelation at the f0 lag)
    falls below ``threshold`` are treated as fully aperiodic, mirroring
    D4C LoveTrain.
    """
    x = np.asarray(x, dtype=np.float64)
    f0 = np.asarray(f0, dtype=np.float64)
    t = np.asarray(temporal_positions)
    if fft_size is None:
        fft_size = get_cheaptrick_fft_size(fs, 71.0)
    half = fft_size // 2
    T = len(f0)
    n_bands = get_num_aperiodicities(fs)
    centers = np.rint(t * fs).astype(np.int64)

    voiced = f0 > 0
    f0_safe = np.where(voiced, np.maximum(f0, 3.0 * fs / (fft_size - 3.0)), DEFAULT_F0)
    period = fs / f0_safe  # samples, fractional

    # long segment: must hold the analysis window plus +-2 periods of shift
    shifts = np.array([-2.0, -1.0, 1.0, 2.0])
    max_shift = 2.0 * period.max()
    L_long = int(2 ** np.ceil(np.log2(fft_size + 2 * max_shift + 4)))
    comb_gain = 1.0 + 1.0 / len(shifts)  # white-noise power gain of x - mean

    freqs_long = np.fft.rfftfreq(L_long, d=1.0)  # cycles/sample
    win = np.hanning(fft_size)
    lo = (L_long - fft_size) // 2
    band_masks = []
    bin_freqs = np.arange(half + 1) * (fs / fft_size)
    for b in range(n_bands):
        f_lo = FREQUENCY_INTERVAL * (b + 0.5)
        f_hi = FREQUENCY_INTERVAL * (b + 1.5)
        band_masks.append((bin_freqs >= f_lo) & (bin_freqs < f_hi))

    use_native = (
        native.available() and _is_pow2(fft_size) and _is_pow2(L_long)
    )
    if use_native:
        coarse = native.d4c_coarse(
            x, period, centers, fs, fft_size, L_long,
            FREQUENCY_INTERVAL, n_bands,
        )
    else:
        coarse = np.ones((T, n_bands))
    chunk = max(1, int(64 * 1024 * 1024 / (L_long * 16 * 2)))
    for c0 in [] if use_native else range(0, T, chunk):
        c1 = min(c0 + chunk, T)
        seg = _gather_frames(x, centers[c0:c1], L_long)
        S = np.fft.rfft(seg, axis=1)
        # mean of the K phase ramps = the comb's periodic-part predictor
        theta = (
            2.0 * np.pi
            * period[c0:c1, None, None]
            * shifts[None, :, None]
            * freqs_long[None, None, :]
        )
        comb = np.exp(-1j * theta).mean(axis=1)  # (chunk, L_long//2+1)
        resid = np.fft.irfft(S * (1.0 - comb), n=L_long, axis=1)
        resid = resid[:, lo : lo + fft_size] * win
        orig = seg[:, lo : lo + fft_size] * win
        P_r = np.abs(np.fft.rfft(resid, axis=1)) ** 2
        P_x = np.abs(np.fft.rfft(orig, axis=1)) ** 2
        for b, mask in enumerate(band_masks):
            if not mask.any():
                continue
            r = P_r[:, mask].sum(axis=1) / (comb_gain * np.maximum(
                P_x[:, mask].sum(axis=1), _EPS))
            coarse[c0:c1, b] = np.clip(np.sqrt(r), 0.001, 1.0)

    # LoveTrain-style gate: low-periodicity frames are fully aperiodic
    max_lag = int(fs / 71.0)
    if native.available():
        periodicity = native.periodicity(x, f0_safe, centers, fs, max_lag)
    else:
        ac_len = int(2 ** np.ceil(np.log2(2 * max_lag + 1)))
        frames = _gather_frames(x, centers, ac_len)
        frames = frames - frames.mean(axis=1, keepdims=True)
        spec = np.fft.rfft(frames, n=2 * ac_len, axis=1)
        ac = np.fft.irfft(spec * np.conj(spec), axis=1)
        r0 = np.maximum(ac[:, 0], _EPS)
        lag = np.clip(np.rint(fs / f0_safe).astype(np.int64), 2, max_lag)
        periodicity = ac[np.arange(T), lag] / r0
    aperiodic_frame = (~voiced) | (periodicity < (1.0 - threshold))
    coarse = np.where(aperiodic_frame[:, None], 1.0 - 1e-12, coarse)

    # expand bands to the full frequency axis (linear interp in dB domain)
    coarse_db = 20.0 * np.log10(np.maximum(coarse, 1e-12))
    return decode_aperiodicity_np(coarse_db, fs, fft_size)
