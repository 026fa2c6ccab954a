"""NSF-compatible CLI: f0/mgc/bap files -> waveform; the port's copy of
``ensemble_svs_with_interactions_tpu/bin/nsf.py``, whose arguments follow
NNSVS's ``NSF`` command.  The vocoder runs on ``--device`` (``cuda``
unless ``--device cpu``).

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.nsf
       input.f0 input.mgc input.bap model_dir output.wav [--vocoder world]
       [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from scipy.io import wavfile

from ensemble_svs_with_interactions_tpu_torch.neutrino import (
    NEUTRINO,
    load_neutrino_features,
)
from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    get_static_stream_sizes,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input_f0")
    ap.add_argument("input_mgc")
    ap.add_argument("input_bap")
    ap.add_argument("model_dir")
    ap.add_argument("output_wav")
    ap.add_argument("--vocoder", default="world")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model_dir = Path(args.model_dir)
    if not model_dir.exists():
        model_dir = Path("model") / model_dir
    engine = NEUTRINO(model_dir, verbose=1, device=args.device)
    cfg = engine.acoustic_model.config
    static = get_static_stream_sizes(cfg.stream_sizes,
                                     cfg.has_dynamic_features,
                                     cfg.num_windows)
    f0, mgc, bap = load_neutrino_features(
        args.input_f0, args.input_mgc, args.input_bap, int(static[0]),
        engine.get_num_aperiodicities())
    wav = engine.predict_waveform_neutrino(f0, mgc, bap,
                                           vocoder_type=args.vocoder)
    wavfile.write(args.output_wav, engine.sample_rate, wav)
    print(f"NSF: wrote {args.output_wav} "
          f"({len(wav) / engine.sample_rate:.2f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
