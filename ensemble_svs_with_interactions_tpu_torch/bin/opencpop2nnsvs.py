"""Convert Opencpop-style segmented data to this framework's recipe layout.

The port's copy of the JAX package's ``bin/opencpop2nnsvs.py``, with the
behaviour of the reference's utils/opencpop2nnsvs.py:
``transcriptions.txt`` rows (utt|text|phonemes|notes|note_durs|ph_durs|slurs)
become HTS full-context labels with the minimal context template
``xx@xx^xx-{ph}+xx=xx_xx%-{p12}!/D:{d1}!/E:{e1}]@{e7}#|{slur}]/F:{f1}#...``
where p12 counts the phoneme position within its note, D/E/F carry
prev/current/next note names and e7 the note length in 10 ms units.
Score labels place phones on the note grid; align labels use the phone
durations (rounded to 5 ms so they sit on the frame grid).

Outputs: <out>/acoustic/label_phone_score, label_phone_align, wav,
<out>/duration/label_phone_align, <out>/timelag/label_phone_{score,align},
and train_no_dev/dev/eval lists.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.io.hts import HTSLabels


def _round_ph_durs(ph_durs):
    """Snap phone durations onto the 5 ms frame grid, shifting the
    remainder into the next phone (reference :184-197)."""
    d = np.asarray(ph_durs, np.float64).copy()
    for i in range(len(d) - 1):
        offset = 0.005 - d[i] % 0.005
        d[i] += offset
        d[i + 1] -= offset
    return np.round(d, 5)


def _contexts(phs, notes, note_durs, is_slurs):
    note_durs_10ms = np.rint(np.asarray(note_durs, np.float64) / 0.01).astype(int)
    ctxs, p12s = [], []
    p12, prev_nd = 0, None
    for i, (ph, note, nd, nd10, slur) in enumerate(
        zip(phs, notes, note_durs, note_durs_10ms, is_slurs)
    ):
        p12 = 1 if (prev_nd is not None and nd != prev_nd) else p12 + 1
        prev_nd = nd
        d1 = notes[i - 1] if i > 0 else "xx"
        f1 = notes[i + 1] if i < len(notes) - 1 else "xx"
        ctxs.append(
            f"xx@xx^xx-{ph}+xx=xx_xx%-{p12}!/D:{d1}!/E:{note}]@{nd10}"
            f"#|{slur}]/F:{f1}#/J:xx~xx@xx"
        )
        p12s.append(p12)
    return ctxs, note_durs_10ms


def make_score_labels(phs, notes, note_durs, is_slurs) -> HTSLabels:
    ctxs, nd10 = _contexts(phs, notes, note_durs, is_slurs)
    starts, ends = [], []
    t, prev_nd = 0.0, None
    for nd, nd10_i in zip(note_durs, nd10):
        if prev_nd is not None and nd != prev_nd:
            t += prev_nd10 * 0.01
        prev_nd, prev_nd10 = nd, nd10_i
        starts.append(int(1e7 * t))
        ends.append(int(1e7 * (t + nd10_i * 0.01)))
    return HTSLabels(np.asarray(starts), np.asarray(ends), ctxs)


def make_align_labels(phs, notes, note_durs, ph_durs, is_slurs) -> HTSLabels:
    ctxs, _ = _contexts(phs, notes, note_durs, is_slurs)
    ph_durs = _round_ph_durs(ph_durs)
    starts = np.concatenate([[0.0], np.cumsum(ph_durs)[:-1]])
    ends = starts + ph_durs
    return HTSLabels(
        np.rint(1e7 * starts).astype(np.int64),
        np.rint(1e7 * ends).astype(np.int64),
        ctxs,
    )


def parse_transcriptions(path: Path):
    utts = {}
    for line in path.read_text().splitlines():
        if not line.strip():
            continue
        cols = line.split("|")
        utt_id, _text, phs, notes, note_durs, ph_durs, slurs = cols[:7]
        utts[utt_id] = dict(
            phs=phs.split(),
            notes=notes.split(),
            note_durs=[float(v) for v in note_durs.split()],
            ph_durs=[float(v) for v in ph_durs.split()],
            is_slurs=[int(float(v)) for v in slurs.split()],
        )
    return utts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("in_dir")
    ap.add_argument("out_dir")
    args = ap.parse_args(argv)
    in_dir, out_dir = Path(args.in_dir), Path(args.out_dir)

    utts = parse_transcriptions(in_dir / "transcriptions.txt")

    dirs = {
        "ac_score": out_dir / "acoustic" / "label_phone_score",
        "ac_align": out_dir / "acoustic" / "label_phone_align",
        "ac_wav": out_dir / "acoustic" / "wav",
        "dur_align": out_dir / "duration" / "label_phone_align",
        "tl_score": out_dir / "timelag" / "label_phone_score",
        "tl_align": out_dir / "timelag" / "label_phone_align",
        "list": out_dir / "list",
    }
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)

    for utt_id, u in utts.items():
        score = make_score_labels(u["phs"], u["notes"], u["note_durs"], u["is_slurs"])
        align = make_align_labels(
            u["phs"], u["notes"], u["note_durs"], u["ph_durs"], u["is_slurs"]
        )
        for key in ("ac_score", "tl_score"):
            score.save(dirs[key] / f"{utt_id}.lab")
        for key in ("ac_align", "dur_align", "tl_align"):
            align.save(dirs[key] / f"{utt_id}.lab")
        wav = in_dir / "wavs" / f"{utt_id}.wav"
        if wav.exists():
            shutil.copyfile(wav, dirs["ac_wav"] / f"{utt_id}.wav")

    # train/test splits (reference :173-180: test doubles as dev and eval)
    def _ids(list_path):
        if not list_path.exists():
            return sorted(utts)
        return [
            line.strip().split("|")[0]
            for line in list_path.read_text().splitlines()
            if line.strip()
        ]

    for name, path in [
        ("train_no_dev", in_dir / "train.txt"),
        ("dev", in_dir / "test.txt"),
        ("eval", in_dir / "test.txt"),
    ]:
        ids = [i for i in _ids(path) if i in utts]
        (dirs["list"] / f"{name}.list").write_text("\n".join(ids) + "\n")

    print(f"converted {len(utts)} utterances -> {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
