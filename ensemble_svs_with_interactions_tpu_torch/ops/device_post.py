"""Device-side acoustic postprocessing for the static-stream WORLD
configuration: the counterpart of ``fused_world_postprocess`` in
``ensemble_svs_with_interactions_tpu/ops/device_post.py``.

Normalized acoustic predictions -> (mgc, lf0, vuv, bap) on the device:
scaler inverse, GV postfilter over note frames, V/UV-gated log-F0 filled
by linear interpolation, and scipy-exact ``filtfilt`` trajectory smoothing
(odd extension, ``lfilter_zi`` initial states) whose IIR passes are a
Python loop over frames (:func:`_lfilter_scan`).  All tensors are batched
(N, T_pad, ...) with ragged valid lengths.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_BIG = 1 << 30


def scaler_affine(scaler, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Any affine scaler's inverse_transform as (a, b): x * a + b."""
    zero = np.zeros((1, dim), np.float64)
    one = np.ones((1, dim), np.float64)
    b = np.asarray(scaler.inverse_transform(zero), np.float64)[0]
    a = np.asarray(scaler.inverse_transform(one), np.float64)[0] - b
    return a.astype(np.float32), b.astype(np.float32)


def filtfilt_coeffs(cutoffs_hz, fs: int):
    """Per-channel 5th-order Butterworth (b, a, zi) rows, float32 (C, 6),
    (C, 6), (C, 5)."""
    from scipy.signal import butter, lfilter_zi

    rows = {}
    bs, azs, zis = [], [], []
    for c in cutoffs_hz:
        key = float(c)
        if key not in rows:
            b, a = butter(5, key / (fs // 2), "lowpass")
            rows[key] = (b, a, lfilter_zi(b, a))
        bs.append(rows[key][0])
        azs.append(rows[key][1])
        zis.append(rows[key][2])
    return (np.asarray(bs, np.float32), np.asarray(azs, np.float32),
            np.asarray(zis, np.float32))


def _lfilter_scan(x, b, a, z0):
    """IIR direct form II transposed over time: x (N, L, C), b/a (C, K+1),
    z0 (N, C, K) initial conditions -> y (N, L, C)."""
    N, L, C = x.shape
    K = b.shape[1] - 1
    bx0 = x * b[:, 0]                          # (N, L, C)
    bxk = x[..., None] * b[:, 1:]              # (N, L, C, K)
    ak = a[:, 1:]
    y = torch.empty_like(x)
    # z[..., K] stays 0, so z[..., 1:] is "the next state or 0"
    z = F.pad(z0, (0, 1))
    z_next = torch.zeros_like(z)
    for t in range(L):
        yt = torch.add(bx0[:, t], z[..., 0], out=y[:, t])
        torch.addcmul(bxk[:, t] + z[..., 1:], ak, yt[..., None], value=-1.0,
                      out=z_next[..., :K])
        z, z_next = z_next, z
    return y


def _ragged_reverse(y, valid_len):
    """Reverse each row's valid prefix y[n, :valid_len[n]] into its front
    (the tail holds garbage), as flip + per-row roll."""
    N, L = y.shape[0], y.shape[1]
    idx = torch.arange(L, device=y.device)[None, :]
    src = (valid_len[:, None] - 1 - idx) % L
    return torch.gather(y, 1, src[..., None].expand(y.shape))


def _filtfilt_ragged(x, lengths, b, a, zi, pad: int = 18):
    """scipy.signal.filtfilt (odd extension, zi * x0 initial states) of
    each (T, C) row over its first ``lengths[n]`` frames; frames past the
    length are garbage."""
    N, T, C = x.shape
    L = T + 2 * pad
    head = 2.0 * x[:, :1] - x[:, 1: pad + 1].flip(1)
    buf = torch.cat([head, x, x.new_zeros(N, pad, C)], dim=1)
    last = lengths - 1
    rows = torch.arange(N, device=x.device)[:, None]
    x_last = x[rows[:, 0], last.clamp(0, T - 1)]
    tail_idx = (last[:, None] - 1
                - torch.arange(pad, device=x.device)[None, :]).clamp(0, T - 1)
    tail = 2.0 * x_last[:, None, :] - x[rows, tail_idx]
    pos = pad + lengths[:, None] + torch.arange(pad, device=x.device)[None, :]
    buf = buf.scatter(1, pos[..., None].expand(N, pad, C), tail)

    valid_len = lengths + 2 * pad
    y1 = _lfilter_scan(buf, b, a, zi[None] * buf[:, 0][..., None])
    y1r = _ragged_reverse(y1, valid_len)
    y2 = _lfilter_scan(y1r, b, a, zi[None] * y1r[:, 0][..., None])
    y = _ragged_reverse(y2, valid_len)
    return y[:, pad: pad + T]


def interp_lf0(lf0_voiced, voiced_mask):
    """np.interp-style fill of log-F0 over unvoiced gaps, per row of
    (N, T): linear between voiced frames, edge-held outside, zeros when a
    row has no voiced frame."""
    N, T = lf0_voiced.shape
    idx = torch.arange(T, device=lf0_voiced.device).expand(N, T)
    prev = torch.cummax(torch.where(voiced_mask, idx, -_BIG), dim=1).values
    nxt = torch.cummin(torch.where(voiced_mask, idx, _BIG).flip(1),
                       dim=1).values.flip(1)
    v_prev = torch.gather(lf0_voiced, 1, prev.clamp(0, T - 1))
    v_next = torch.gather(lf0_voiced, 1, nxt.clamp(0, T - 1))
    span = (nxt - prev).clamp_min(1)
    w = (idx - prev).to(lf0_voiced.dtype) / span.to(lf0_voiced.dtype)
    mid = v_prev + w * (v_next - v_prev)
    out = torch.where(prev < 0, v_next, torch.where(nxt >= _BIG, v_prev, mid))
    out = torch.where(nxt == prev, v_prev, out)
    return torch.where(voiced_mask.any(dim=1, keepdim=True), out,
                       torch.zeros_like(out))


def variance_scaling_masked(x, gv, mask):
    """GV postfilter over masked frames: x (N, T, D), gv (D,), mask (N, T)
    bool (note frames within the valid length).  The first two dims (power
    and the first cepstral coefficient) are left as they are."""
    m = mask[..., None].to(x.dtype)
    cnt = m.sum(dim=1, keepdim=True).clamp_min(1.0)
    mu = (x * m).sum(dim=1, keepdim=True) / cnt
    var = (((x - mu) ** 2) * m).sum(dim=1, keepdim=True) / cnt
    scaled = torch.sqrt(gv / var.clamp_min(1e-12)) * (x - mu) + mu
    dims = torch.arange(x.shape[-1], device=x.device) >= 2
    out = torch.where(mask[..., None] & dims, scaled, x)
    return torch.where(mask.any(dim=1)[:, None, None], out, x)


def fused_world_postprocess(pred, lengths, note_mask, affine_a, affine_b, gv,
                            filt_b, filt_a, filt_zi, *,
                            stream_sizes: Tuple[int, ...], apply_gv: bool):
    """Normalized predictions (N, T_pad, D) -> device (mgc, lf0, vuv, bap).

    lengths (N,) valid frame counts; note_mask (N, T_pad) GV note frames;
    affine (D,) scaler inverse; gv (mgc_dim,) target variances; filt_*
    per-channel smoothing coefficients over [mgc | bap | lf0] channels.
    Frames are voiced where vuv > 0.5, and the trajectories are always
    smoothed (the JAX package's ``gate_threshold=0.5, smooth=True``).
    """
    s_mgc, s_lf0, s_vuv, s_bap = stream_sizes
    T = pred.shape[1]
    feats = pred.to(torch.float32) * affine_a + affine_b
    mgc = feats[..., :s_mgc]
    lf0_s = feats[..., s_mgc: s_mgc + s_lf0]
    vuv = feats[..., s_mgc + s_lf0: s_mgc + s_lf0 + s_vuv]
    bap = feats[..., s_mgc + s_lf0 + s_vuv:]
    if apply_gv:
        mgc = variance_scaling_masked(mgc, gv, note_mask)
    valid = torch.arange(T, device=pred.device)[None, :] < lengths[:, None]
    voiced = (vuv[..., 0] > 0.5) & valid
    lf0 = interp_lf0(lf0_s[..., 0], voiced)[..., None]
    stacked = torch.cat([mgc, bap, lf0], dim=-1)
    smoothed = _filtfilt_ragged(stacked, lengths, filt_b, filt_a, filt_zi)
    mgc = smoothed[..., :s_mgc]
    bap = smoothed[..., s_mgc: s_mgc + s_bap]
    lf0 = smoothed[..., s_mgc + s_bap:]
    return mgc, lf0, vuv, bap.clamp(-60.0, 0.0)
