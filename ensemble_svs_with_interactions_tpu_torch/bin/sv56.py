"""Active-speech-level gain normalization (first-party sv56 equivalent).

The reference wraps the external ITU-T G.191 ``sv56demo`` binary
(the reference's utils/sv56.py, sv56_inplace.py).  This tool
implements a P.56-style active level measure directly: the active level
is the RMS over "active" frames, where activity is decided by comparing
the smoothed envelope against a threshold a fixed margin (15.9 dB, the
P.56 default) below the active level — solved by fixed-point iteration.
The waveform is then scaled so the active level hits ``--ndb`` dBov.

The port's copy of ``ensemble_svs_with_interactions_tpu/bin/sv56.py``
(host NumPy).

Usage: python -m ...bin.sv56 <in_dir> <out_dir> [--ndb -26] [--inplace]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
from scipy.io import wavfile

MARGIN_DB = 15.9  # P.56 activity margin


def active_speech_level(x: np.ndarray, sr: int, frame_ms: float = 16.0):
    """Return the active speech level in dBov of a float waveform in [-1, 1].

    Fixed-point iteration: threshold = level - MARGIN_DB; level = RMS of
    frames whose envelope exceeds the threshold.  Converges in a few steps.
    """
    x = np.asarray(x, np.float64)
    frame = max(int(sr * frame_ms / 1000.0), 1)
    n = (len(x) // frame) * frame
    if n == 0:
        return -np.inf, np.zeros(0, bool)
    frames = x[:n].reshape(-1, frame)
    energy = (frames**2).mean(axis=1)
    env_db = 10.0 * np.log10(np.maximum(energy, 1e-12))

    level_db = 10.0 * np.log10(np.maximum(energy.mean(), 1e-12))
    active = np.ones_like(env_db, bool)
    for _ in range(20):
        thresh = level_db - MARGIN_DB
        new_active = env_db > thresh
        if not new_active.any():
            break
        new_level = 10.0 * np.log10(np.maximum(energy[new_active].mean(), 1e-12))
        if new_active.tolist() == active.tolist() and abs(new_level - level_db) < 1e-6:
            break
        active, level_db = new_active, new_level
    return level_db, active


def normalize(x: np.ndarray, sr: int, ndb: float = -26.0) -> np.ndarray:
    """Scale ``x`` (float, [-1, 1]) so the active level is ``ndb`` dBov."""
    level_db, _ = active_speech_level(x, sr)
    if not np.isfinite(level_db):
        return x
    gain = 10.0 ** ((ndb - level_db) / 20.0)
    y = x * gain
    peak = np.abs(y).max()
    if peak > 1.0:  # avoid clipping, mirror sv56demo's saturation warning
        y = y / peak * 0.99
    return y


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("in_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--ndb", type=float, default=-26.0)
    args = ap.parse_args(argv)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for path in sorted(Path(args.in_dir).glob("*.wav")):
        sr, x = wavfile.read(path)
        if x.dtype == np.int16:
            xf = x.astype(np.float64) / 32768.0
        elif x.dtype == np.int32:
            xf = x.astype(np.float64) / 2147483648.0
        else:
            xf = np.asarray(x, np.float64)
        if xf.ndim > 1:
            xf = xf.mean(axis=1)
        y = normalize(xf, sr, args.ndb)
        wavfile.write(
            out_dir / path.name, sr, (np.clip(y, -1, 1) * 32767).astype(np.int16)
        )
        n += 1
    print(f"normalized {n} files -> {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
