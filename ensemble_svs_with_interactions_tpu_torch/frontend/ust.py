"""UST (UTAU project) -> Sinsy-style HTS full-context labels, a copy of the
JAX package's ``frontend/ust.py``.

First-party replacement for the utaupy ``ust2hts`` path NNSVS's
NEUTRINO-compatible server uses for score upload (``ust2hts(ust_path,
full_lab, kana2phonemes.table, strict_sinsy_style=False)``).  Parses the
INI-style UST note list (Length in 480-per-quarter ticks, NoteNum MIDI,
Lyric kana, inline Tempo changes), converts lyrics to Sinsy phonemes —
through the pack's ENUNU ``kana2phonemes.table`` when one is provided,
falling back to the built-in kana G2P — and emits labels through the same
:func:`frontend.musicxml.notes_to_labels` backend as the MusicXML
frontend.

UST has no time-signature record; measure contexts assume 4/4 (1920
ticks), the UTAU editor's own grid.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Union

from ensemble_svs_with_interactions_tpu_torch.frontend.musicxml import (
    HTS_FRAME,
    VOWELS,
    ScoreNote,
    g2p_ja,
    score_to_labels,
)
from ensemble_svs_with_interactions_tpu_torch.io import hts

TICKS_PER_QUARTER = 480
TICKS_PER_MEASURE = 4 * TICKS_PER_QUARTER  # 4/4 assumed (UTAU grid)

_REST_LYRICS = {"", "r", "R", "pau", "sil", "rest", "休"}


def _read_text(path) -> str:
    """UST files are conventionally Shift-JIS; newer tools write UTF-8."""
    data = Path(path).read_bytes()
    for enc in ("utf-8-sig", "cp932", "utf-8"):
        try:
            return data.decode(enc)
        except UnicodeDecodeError:
            continue
    return data.decode("utf-8", errors="replace")


def load_table(path) -> Dict[str, List[str]]:
    """ENUNU ``kana2phonemes.table``: one ``lyric ph1 ph2 ...`` per line."""
    table: Dict[str, List[str]] = {}
    for line in _read_text(path).splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "//")):
            continue
        parts = line.split()
        if len(parts) >= 2:
            table[parts[0]] = parts[1:]
    return table


def clean_lyric(lyric: str) -> str:
    """Normalize a UTAU lyric to its kana core.

    Handles VCV entries (``a あ`` -> ``あ``), CV prefixes (``- あ``),
    and ASCII voice-bank suffixes (``あC4`` -> ``あ``)."""
    lyric = lyric.strip()
    if " " in lyric:  # VCV: "<prev vowel> <kana>"
        lyric = lyric.split()[-1]
    lyric = lyric.lstrip("-").strip()
    if lyric and any(ord(c) >= 128 for c in lyric):
        # strip trailing ASCII suffix flags (pitch suffixes like C4)
        while lyric and ord(lyric[-1]) < 128:
            lyric = lyric[:-1]
    return lyric


def parse_ust(path_or_text: Union[str, Path], table=None) -> List[ScoreNote]:
    """Parse a UST file (or its text) into timed :class:`ScoreNote` s.

    ``table`` optionally maps lyrics to phoneme lists (an ENUNU
    ``kana2phonemes.table`` path or a dict); unmapped lyrics go through
    the built-in kana G2P."""
    text = (
        str(path_or_text)
        if "[#" in str(path_or_text)
        else _read_text(path_or_text)
    )
    if table is not None and not isinstance(table, dict):
        table = load_table(table)

    # --- INI-ish section scan ------------------------------------------------
    tempo = 120.0
    sections: List[Dict[str, str]] = []
    cur: Optional[Dict[str, str]] = None
    in_setting = False
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("[#"):
            tag = line[2:].rstrip("]")
            in_setting = tag.upper() == "SETTING"
            cur = None
            if tag.isdigit() or tag.upper() in ("INSERT", "DELETE"):
                cur = {}
                sections.append(cur)
            continue
        if "=" not in line:
            continue
        key, val = line.split("=", 1)
        if in_setting and key == "Tempo":
            try:
                tempo = float(val)
            except ValueError:
                pass
        elif cur is not None:
            cur[key] = val

    # --- notes ---------------------------------------------------------------
    notes: List[ScoreNote] = []
    tick = 0
    t = 0  # 100 ns
    prev_vowel: Optional[str] = None
    for sec in sections:
        try:
            length = int(float(sec.get("Length", 0)))
        except ValueError:
            length = 0
        if length <= 0:
            continue
        if sec.get("Tempo"):
            try:
                tempo = float(sec["Tempo"].lstrip("!"))  # UTAU marks local tempo "!120"
            except ValueError:
                pass
        sec_dur = length / TICKS_PER_QUARTER * 60.0 / tempo
        dur = int(round(sec_dur * 1e7 / HTS_FRAME)) * HTS_FRAME

        lyric = clean_lyric(sec.get("Lyric", ""))
        is_rest = lyric in _REST_LYRICS
        midi = None if is_rest else int(float(sec.get("NoteNum", 60)))

        if is_rest and notes and notes[-1].midi is None:
            notes[-1].duration += dur  # merge adjacent rests
        else:
            n = ScoreNote(
                start=t,
                duration=dur,
                midi=midi,
                lyric=lyric,
                tempo=tempo,
                beats=4,
                beat_type=4,
                fifths=0,
                measure_index=tick // TICKS_PER_MEASURE,
            )
            if midi is not None:
                phs = None
                if table:
                    phs = table.get(lyric) or table.get(sec.get("Lyric", "").strip())
                if phs is None:
                    phs = g2p_ja(lyric, prev_vowel)
                if not phs:
                    phs = [prev_vowel or "a"]  # melisma ("+"/"ー" entries)
                n.phonemes = list(phs)
                pv = [p for p in n.phonemes if p in VOWELS and p != "cl"]
                if pv:
                    prev_vowel = pv[-1]
            notes.append(n)
        tick += length
        t += dur

    # --- measure spans (notes grouped by 1920-tick measure index) -----------
    starts: Dict[int, int] = {}
    ends: Dict[int, int] = {}
    for n in notes:
        mi = n.measure_index
        starts[mi] = min(starts.get(mi, n.start), n.start)
        ends[mi] = max(ends.get(mi, 0), n.start + n.duration)
    for n in notes:
        n.measure_start = starts[n.measure_index]
        n.measure_duration = ends[n.measure_index] - starts[n.measure_index]
    return notes


def ust_to_labels(path_or_text, table=None) -> hts.HTSLabels:
    """Parse a UST score into full-context labels (0.5 s silence padding,
    same backend as :func:`frontend.musicxml.musicxml_to_labels`).

    NOTE: :func:`parse_ust` phonemizes through the table already;
    ``notes_to_labels`` re-phonemizes only notes with empty ``phonemes``."""
    notes = parse_ust(path_or_text, table=table)
    return score_to_labels(notes, origin="ust")
