"""Analysis-by-synthesis (copy-synthesis) check; the port's copy of
``ensemble_svs_with_interactions_tpu/bin/anasyn.py``.

WORLD analysis of a wav on the host (``ops/world/analysis``), optionally
a round trip through the codecs (mgc/bap, the WORLD basis), then WORLD
synthesis on ``--device`` (``cuda`` unless ``--device cpu``) with
excitation noise drawn from a CPU ``torch.Generator`` seeded ``--seed``,
so that the card and the CPU render the same excitation.  Useful to check
the vocoder ceiling on a corpus.

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.anasyn
       <wav_in> <wav_out> [--sample-rate N] [--f0-extractor dio|harvest]
       [--use-codec] [--mgc-order N] [--device cpu] [--seed 0]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from scipy.io import wavfile

from ensemble_svs_with_interactions_tpu_torch.data.data_source import load_wav
from ensemble_svs_with_interactions_tpu_torch.ops.world import (
    analysis,
    codec,
)
from ensemble_svs_with_interactions_tpu_torch.ops.world.synthesis import (
    synthesize,
)


def excitation_noise(samples: int, generator: torch.Generator):
    """(1, samples) standard normal excitation drawn from ``generator``."""
    return torch.randn((1, samples), generator=generator)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("wav_in")
    ap.add_argument("wav_out")
    ap.add_argument("--sample-rate", type=int, default=None)
    ap.add_argument("--f0-extractor", default="dio",
                    choices=["dio", "harvest"])
    ap.add_argument("--f0-floor", type=float, default=71.0)
    ap.add_argument("--f0-ceil", type=float, default=800.0)
    ap.add_argument("--use-codec", action="store_true",
                    help="round-trip through the mgc/bap codecs")
    ap.add_argument("--mgc-order", type=int, default=59)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    x, fs = load_wav(args.wav_in, args.sample_rate)
    extractor = (analysis.harvest if args.f0_extractor == "harvest"
                 else analysis.dio)
    f0, t = extractor(x, fs, f0_floor=args.f0_floor, f0_ceil=args.f0_ceil)
    f0 = analysis.stonemask(x, f0, t, fs)
    sp = analysis.cheaptrick(x, f0, t, fs)
    ap_ = analysis.d4c(x, f0, t, fs)

    if args.use_codec:
        fft_size = codec.get_cheaptrick_fft_size(fs)
        mgc = np.asarray(codec.code_spectral_envelope(
            sp, fs, args.mgc_order + 1, basis="world"))
        bap = np.asarray(codec.code_aperiodicity(ap_, fs))
        sp = codec.decode_spectral_envelope_np(mgc, fs, fft_size)
        ap_ = codec.decode_aperiodicity_np(bap, fs, fft_size)

    device = torch.device(args.device)
    hop = int(fs * 5.0 / 1000.0)
    noise = excitation_noise(
        len(f0) * hop, torch.Generator().manual_seed(args.seed)).to(device)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)[None]

    y = synthesize(dev(f0), dev(sp), dev(ap_), noise, fs)[0].cpu().numpy()
    peak = np.abs(y).max()
    if peak > 1.0:
        y = y / peak
    wavfile.write(args.wav_out, fs, (y * 32767).astype(np.int16))
    n = min(len(x), len(y))
    rms_db = 20 * np.log10(
        (np.sqrt(np.mean(y[:n] ** 2)) + 1e-12)
        / (np.sqrt(np.mean(x[:n] ** 2)) + 1e-12)
    )
    print(
        f"copy-synthesis: {len(y)/fs:.2f}s, voiced {np.mean(f0>0):.2f}, "
        f"RMS delta {rms_db:+.2f} dB -> {args.wav_out}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
