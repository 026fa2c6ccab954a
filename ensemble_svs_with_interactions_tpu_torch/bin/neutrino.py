"""NEUTRINO-compatible CLI: a score or full labels -> timing labels and
f0/mgc/bap files; the port's copy of
``ensemble_svs_with_interactions_tpu/bin/neutrino.py``, whose arguments
follow NNSVS's ``NEUTRINO`` command.  The models run on ``--device``
(``cuda`` unless ``--device cpu``).

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.neutrino
       <full.lab | score.musicxml | score.ust> timing.lab out.f0 out.mgc
       out.bap model_dir [-i phraselist] [-p phrase_num] [-k style_shift]
       [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.neutrino import (
    NEUTRINO,
    save_neutrino_features,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input_file")
    ap.add_argument("timing_lab")
    ap.add_argument("output_f0")
    ap.add_argument("output_mgc")
    ap.add_argument("output_bap")
    ap.add_argument("model_dir")
    ap.add_argument("-i", "--phraselist", default=None)
    ap.add_argument("-p", "--phrase_num", type=int, default=-1)
    ap.add_argument("-k", "--style_shift", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model_dir = Path(args.model_dir)
    if not model_dir.exists():
        model_dir = Path("model") / model_dir
    engine = NEUTRINO(model_dir, verbose=1, device=args.device)

    name = str(args.input_file).lower()
    if name.endswith((".xml", ".musicxml")):
        full_labels = engine.musicxml_to_labels(args.input_file)
    elif name.endswith(".ust"):
        full_labels = engine.ust_to_labels(args.input_file)
    else:
        full_labels = hts.load(args.input_file)
    timing_labels = engine.predict_timing(full_labels.copy())
    timing_labels.save(args.timing_lab)

    if args.phraselist:
        Path(args.phraselist).write_text(
            engine.get_phraselist(full_labels, timing_labels))

    f0, mgc, bap = engine.predict_acoustic_neutrino(
        full_labels, timing_labels=timing_labels,
        style_shift=args.style_shift, phrase_num=args.phrase_num)
    save_neutrino_features(args.output_f0, args.output_mgc, args.output_bap,
                           f0, mgc, bap)
    print(f"NEUTRINO: {len(f0)} frames -> {args.output_f0} / "
          f"{args.output_mgc} / {args.output_bap}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
