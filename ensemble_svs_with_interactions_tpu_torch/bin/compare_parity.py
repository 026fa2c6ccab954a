"""Parity comparison tooling (PARITY_PROTOCOL.md).

Three subcommands:

  codec   — compare this framework's WORLD codecs against a pyworld
            binary (when ``pyworld`` is importable) or dump/compare
            ``.npz`` artifacts for an offline two-machine comparison.
  analyze — run WORLD analysis (f0/sp/ap + coded streams) on a wav and
            dump the arrays for cross-framework comparison.
  metrics — reference-formula MCD / BAP-MCD / VUV% / F0-RMSE between two
            directories of acoustic feature dumps (e.g. this framework's
            predictions vs reference-pipeline ground truth), aggregated
            per-utterance and overall.

Reference formulas: the reference's nnsvs/train_util.py (the per-epoch
ObjEval metrics); codec call sites in its nnsvs/gen.py.  The port's copy
of the JAX package's ``bin/compare_parity.py``: ``pyworld`` is used only
where it imports, and the WORLD codecs and analysis are the port's host
NumPy ones.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


# --------------------------------------------------------------------------
# codec
# --------------------------------------------------------------------------


def _codec_fixture(fs: int, fft_size: int, frames: int, seed: int):
    """Deterministic smooth test envelopes shared by both sides of the
    comparison (seeded — both machines generate identical inputs)."""
    rng = np.random.default_rng(seed)
    half = fft_size // 2 + 1
    # smooth log envelope via cumulative-sum filtering (no scipy needed)
    raw = rng.normal(size=(frames, half))
    kernel = np.hanning(65)
    kernel /= kernel.sum()
    log_sp = np.apply_along_axis(
        lambda r: np.convolve(r, kernel, mode="same"), 1, raw
    ) * 6.0 - 8.0
    sp = np.exp(log_sp)
    ap_db = np.clip(
        np.apply_along_axis(
            lambda r: np.convolve(r, kernel, mode="same"), 1,
            rng.uniform(-40.0, -1.0, size=(frames, half)),
        ),
        -59.0, -0.1,
    )
    ap = 10.0 ** (ap_db / 20.0)
    return sp, ap


def cmd_codec(args) -> int:
    from ensemble_svs_with_interactions_tpu_torch.ops.world import codec

    fs = args.fs
    fft_size = codec.get_cheaptrick_fft_size(fs)
    sp, ap = _codec_fixture(fs, fft_size, args.frames, args.seed)
    mine = {
        "fs": np.asarray(fs),
        "fft_size": np.asarray(fft_size),
        "coded_sp": np.asarray(
            codec.code_spectral_envelope(sp, fs, args.dims, basis="world")
        ),
        "coded_ap": np.asarray(codec.code_aperiodicity(ap, fs)),
    }
    mine["decoded_sp"] = np.asarray(
        codec.decode_spectral_envelope_np(mine["coded_sp"], fs, fft_size)
    )
    mine["decoded_ap"] = np.asarray(
        codec.decode_aperiodicity_np(mine["coded_ap"], fs, fft_size)
    )

    if args.compare:
        theirs = np.load(args.compare)
        report = _compare_trees(mine, theirs, args.atol)
        print(json.dumps(report, indent=1))
        return 0 if report["max_abs_diff"] <= args.atol else 1

    try:
        import pyworld  # noqa: F401  (only on the parity machine)
    except ImportError:
        pyworld = None

    if pyworld is not None:
        theirs = {
            "coded_sp": pyworld.code_spectral_envelope(sp, fs, args.dims),
            "coded_ap": pyworld.code_aperiodicity(ap, fs),
        }
        theirs["decoded_sp"] = pyworld.decode_spectral_envelope(
            theirs["coded_sp"], fs, fft_size
        )
        theirs["decoded_ap"] = pyworld.decode_aperiodicity(
            np.ascontiguousarray(theirs["coded_ap"]), fs, fft_size
        )
        report = _compare_trees(mine, theirs, args.atol)
        print(json.dumps(report, indent=1))
        return 0 if report["max_abs_diff"] <= args.atol else 1

    out = args.out or f"codec_parity_fs{fs}_seed{args.seed}.npz"
    np.savez(out, **mine)
    print(json.dumps({
        "dumped": str(out),
        "note": "pyworld not importable here: run the same command on a "
                "machine with pyworld, or dump there and compare with "
                "--compare <their.npz>",
    }))
    return 0


def _compare_trees(mine: dict, theirs, atol: float) -> dict:
    per_key = {}
    worst = 0.0
    for k in ("coded_sp", "coded_ap", "decoded_sp", "decoded_ap"):
        if k not in mine or k not in theirs:
            continue
        a, b = np.asarray(mine[k], np.float64), np.asarray(theirs[k], np.float64)
        if a.shape != b.shape:
            per_key[k] = {"shape_mismatch": [list(a.shape), list(b.shape)]}
            worst = float("inf")
            continue
        d = float(np.abs(a - b).max())
        rel = float(
            np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
        )
        per_key[k] = {"max_abs_diff": d, "max_rel_diff": rel}
        worst = max(worst, d)
    return {"max_abs_diff": worst, "atol": atol, "per_key": per_key,
            "ok": bool(worst <= atol)}


# --------------------------------------------------------------------------
# analyze
# --------------------------------------------------------------------------


def cmd_analyze(args) -> int:
    from scipy.io import wavfile

    from ensemble_svs_with_interactions_tpu_torch.ops.world import (
        analysis,
        codec,
    )

    sr, x = wavfile.read(args.wav)
    if x.dtype.kind == "i":
        x = x.astype(np.float64) / np.iinfo(x.dtype).max
    if x.ndim > 1:
        x = x.mean(axis=1)
    f0, timeaxis = (
        analysis.harvest(x, sr, frame_period=args.frame_period)
        if args.f0_extractor == "harvest"
        else analysis.dio(x, sr, frame_period=args.frame_period)
    )
    sp = analysis.cheaptrick(x, f0, timeaxis, sr)
    ap = analysis.d4c(x, f0, timeaxis, sr)
    fft_size = (sp.shape[1] - 1) * 2
    out = args.out or (Path(args.wav).stem + "_world.npz")
    np.savez(
        out,
        sr=np.asarray(sr),
        f0=f0,
        sp=sp,
        ap=ap,
        coded_sp=np.asarray(
            codec.code_spectral_envelope(sp, sr, args.dims, basis="world")
        ),
        coded_ap=np.asarray(codec.code_aperiodicity(ap, sr)),
        fft_size=np.asarray(fft_size),
    )
    print(json.dumps({"dumped": str(out), "frames": int(len(f0)),
                      "voiced_ratio": float((f0 > 0).mean())}))
    return 0


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------


def cmd_metrics(args) -> int:
    from ensemble_svs_with_interactions_tpu_torch.train import metrics as M
    from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
        StandardScaler,
    )

    pred_dir, gt_dir = Path(args.pred_dir), Path(args.gt_dir)
    stream_sizes = [int(s) for s in args.stream_sizes.split(",")]
    dyn = [s.strip().lower() in ("1", "true") for s in
           args.has_dynamic_features.split(",")]
    if args.scaler_prefix:
        scaler = StandardScaler(
            np.load(f"{args.scaler_prefix}_mean.npy"),
            np.load(f"{args.scaler_prefix}_var.npy"),
            np.load(f"{args.scaler_prefix}_scale.npy"),
        )
    else:
        d = sum(stream_sizes)
        scaler = StandardScaler(np.zeros(d), np.ones(d), np.ones(d))

    per_utt = {}
    agg: dict = {}
    for p in sorted(pred_dir.glob("*-feats.npy")):
        g = gt_dir / p.name
        if not g.exists():
            continue
        pred, gt = np.load(p), np.load(g)
        T = min(len(pred), len(gt))
        dist = M.compute_distortions(
            pred[None, :T], gt[None, :T], np.asarray([T]), scaler,
            stream_sizes, dyn, args.num_windows,
        )
        per_utt[p.name.replace("-feats.npy", "")] = {
            k: round(float(v), 5) for k, v in dist.items()
        }
        for k, v in dist.items():
            agg.setdefault(k, []).append(float(v))
    if not per_utt:
        print(json.dumps({"error": "no overlapping *-feats.npy files"}))
        return 1
    report = {
        "n_utterances": len(per_utt),
        "mean": {k: round(float(np.mean(v)), 5) for k, v in agg.items()},
        "per_utterance": per_utt,
    }
    print(json.dumps(report, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("codec", help="WORLD codec parity vs pyworld")
    c.add_argument("--fs", type=int, default=48000)
    c.add_argument("--dims", type=int, default=60)
    c.add_argument("--frames", type=int, default=16)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--atol", type=float, default=1e-8)
    c.add_argument("--out", default=None, help="dump .npz here")
    c.add_argument("--compare", default=None,
                   help="another machine's .npz to compare against")
    c.set_defaults(fn=cmd_codec)

    a = sub.add_parser("analyze", help="dump WORLD analysis of a wav")
    a.add_argument("wav")
    a.add_argument("--f0-extractor", choices=("dio", "harvest"),
                   default="harvest")
    a.add_argument("--frame-period", type=float, default=5.0)
    a.add_argument("--dims", type=int, default=60)
    a.add_argument("--out", default=None)
    a.set_defaults(fn=cmd_analyze)

    m = sub.add_parser("metrics", help="ObjEval metrics between dump dirs")
    m.add_argument("pred_dir")
    m.add_argument("gt_dir")
    m.add_argument("--stream-sizes", default="180,3,1,15",
                   help="comma list, e.g. 180,3,1,15 (48k world recipe)")
    m.add_argument("--has-dynamic-features", default="true,true,false,true")
    m.add_argument("--num-windows", type=int, default=3)
    m.add_argument("--scaler-prefix", default=None,
                   help="out_acoustic scaler prefix (omit for denormalized "
                        "dumps)")
    m.add_argument("--out", default=None)
    m.set_defaults(fn=cmd_metrics)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
