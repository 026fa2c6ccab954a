"""Convert this framework's segmented recipe data to Opencpop's structure
(so DiffSinger-style tooling can consume it).

The port's copy of the JAX package's ``bin/nnsvs2opencpop.py``, with the
behaviour of the reference's utils/nnsvs2opencpop.py: for each
utterance, extract phonemes (``-ph+``), current note names (``/E:``,
converted to MIDI numbers), note durations (``@N#`` in 10 ms units), and
aligned phone durations (5 ms frames), and emit one
``transcriptions.txt`` row per utterance plus copied wavs.
"""

from __future__ import annotations

import argparse
import re
import shutil
from pathlib import Path

from ensemble_svs_with_interactions_tpu_torch.frontend.merlin import (
    duration_features,
)
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.io.hts import (
    note_name_to_midi,
)


def _note_midi(context: str) -> int:
    m = re.search(r"/E:([A-Z][b#]?[0-9]+)\]", context)
    return int(note_name_to_midi(m.group(1))) if m else 0


def _note_dur(context: str) -> float:
    m = re.search(r"@(\d+)#", context)
    return int(m.group(1)) / 100.0 if m else 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("in_dir", help="dir with label_phone_score/align + wav")
    ap.add_argument("out_dir")
    args = ap.parse_args(argv)
    in_dir, out_dir = Path(args.in_dir), Path(args.out_dir)

    out_wav_dir = out_dir / "wavs"
    out_wav_dir.mkdir(parents=True, exist_ok=True)

    rows = []
    for score_path in sorted((in_dir / "label_phone_score").glob("*.lab")):
        utt_id = score_path.stem
        align_path = in_dir / "label_phone_align" / f"{utt_id}.lab"
        if not align_path.exists():
            continue
        score = hts.load(score_path)
        align = hts.load(align_path)

        ph = [re.search(r"\-(.*?)\+", c).group(1) for c in score.contexts]
        note = [_note_midi(c) for c in score.contexts]
        note_dur = [_note_dur(c) for c in score.contexts]
        ph_dur = (duration_features(align).reshape(-1) * 0.005).tolist()
        is_slur = [0] * len(ph_dur)
        rows.append(
            "|".join(
                [
                    utt_id,
                    " ".join(ph),
                    " ".join(ph),
                    " ".join(str(n) for n in note),
                    " ".join(str(n) for n in note_dur),
                    " ".join(str(round(n, 3)) for n in ph_dur),
                    " ".join(str(n) for n in is_slur),
                ]
            )
        )
        wav = in_dir / "wav" / f"{utt_id}.wav"
        if wav.exists():
            shutil.copyfile(wav, out_wav_dir / f"{utt_id}.wav")

    (out_dir / "transcriptions.txt").write_text("\n".join(rows) + "\n")
    print(f"wrote {len(rows)} rows -> {out_dir / 'transcriptions.txt'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
