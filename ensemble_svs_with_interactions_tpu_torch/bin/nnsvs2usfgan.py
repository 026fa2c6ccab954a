"""Convert preprocessed vocoder features to the uSFGAN/SiFiGAN training
layout (hdf5 features + wav + scp/list files).

The port's copy of the JAX package's ``bin/nnsvs2usfgan.py`` (``h5py`` is
imported only when it runs), with the behaviour of the reference's
utils/nnsvs2usfgan.py: for
each utterance the normalized ``*-feats.npy`` is denormalized with the
acoustic out-scaler, split into (mgc, lf0, vuv, bap) (world) or
(mel, lf0, vuv) (melf0), and written as an ``.h5`` with keys
``/uv /f0 /contf0 /cf0`` plus ``/mcep /codeap`` (world) or ``/logmsp``
(melf0); waveforms are written as 16-bit-range float wavs; per-split
``.scp`` (wav paths) and ``.list`` (feature paths) files are emitted.

Usage: python -m ...bin.nnsvs2usfgan <dump_norm_dir> <out_dir>
       --scaler-prefix dump/.../out_acoustic_scaler
       [--feature-type world|melf0] [--sample-rate 48000] [--spk spk]
where <dump_norm_dir> contains per-split subdirs with ``in_vocoder``
feature/waveform dumps (``{utt}-feats.npy`` + ``{utt}-wave.npy``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
from scipy.io import wavfile

from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    split_streams,
)
from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
    StandardScaler,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dump_norm_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--scaler-prefix", required=True)
    ap.add_argument("--feature-type", default="world", choices=["world", "melf0"])
    ap.add_argument("--sample-rate", type=int, default=48000)
    ap.add_argument("--spk", default="spk")
    ap.add_argument("--mgc-dim", type=int, default=60)
    ap.add_argument("--relative-path", action="store_true")
    args = ap.parse_args(argv)

    import h5py

    scaler = StandardScaler(
        np.load(f"{args.scaler_prefix}_mean.npy"),
        np.load(f"{args.scaler_prefix}_var.npy"),
        np.load(f"{args.scaler_prefix}_scale.npy"),
    )
    D = len(np.asarray(scaler.mean_).reshape(-1))
    if args.feature_type == "world":
        stream_sizes = [args.mgc_dim, 1, 1, D - args.mgc_dim - 2]
    else:
        stream_sizes = [D - 2, 1, 1]

    dump = Path(args.dump_norm_dir)
    out_dir = Path(args.out_dir)
    out_scp = out_dir / "scp"
    out_h5 = out_dir / "hdf5"
    out_wav = out_dir / "wav"
    for d in (out_scp, out_h5, out_wav):
        d.mkdir(parents=True, exist_ok=True)

    hop_size = aux_channels = -1
    for split in ("dev", "eval", "train_no_dev"):
        feat_dir = dump / split / "norm" / "in_vocoder"
        if not feat_dir.is_dir():
            feat_dir = dump / split  # flat layout fallback
        utt_ids = sorted(p.name[: -len("-feats.npy")]
                         for p in feat_dir.glob("*-feats.npy"))
        kept = []
        for utt_id in utt_ids:
            wave_path = feat_dir / f"{utt_id}-wave.npy"
            if not wave_path.exists():
                continue
            wave = np.load(wave_path).reshape(-1).astype(np.float32)
            feats = scaler.inverse_transform(np.load(feat_dir / f"{utt_id}-feats.npy"))

            parts = [np.asarray(p) for p in split_streams(feats, stream_sizes)]
            if args.feature_type == "world":
                mgc, lf0, vuv, bap = parts
                aux_channels = mgc.shape[-1] + bap.shape[-1]
            else:
                mel, lf0, vuv = parts
                aux_channels = mel.shape[-1]
            vuv = (vuv > 0.5).astype(np.float32)
            contf0 = np.exp(lf0)
            f0 = np.where(vuv < 0.5, 0.0, contf0)
            hop_size = len(wave) // len(feats)

            with h5py.File(out_h5 / f"{utt_id}.h5", "w") as h5:
                h5["/uv"] = vuv
                h5["/f0"] = f0
                h5["/contf0"] = contf0
                h5["/cf0"] = contf0
                if args.feature_type == "world":
                    h5["/mcep"] = mgc
                    h5["/codeap"] = bap
                else:
                    h5["/logmsp"] = mel
            wavfile.write(out_wav / f"{utt_id}.wav", args.sample_rate, wave)
            kept.append(utt_id)

        def _p(path: Path) -> str:
            return str(path if args.relative_path else path.resolve())

        base = f"{args.spk}_sr{args.sample_rate}_{split}"
        (out_scp / f"{base}.scp").write_text(
            "".join(_p(out_wav / f"{u}.wav") + "\n" for u in kept)
        )
        (out_scp / f"{base}.list").write_text(
            "".join(_p(out_h5 / f"{u}.h5") + "\n" for u in kept)
        )
        print(f"{split}: {len(kept)} utterances")

    print(
        f"stream_sizes: {stream_sizes}\nhop_size: {hop_size}\n"
        f"sample_rate: {args.sample_rate}\naux_channels: {aux_channels}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
