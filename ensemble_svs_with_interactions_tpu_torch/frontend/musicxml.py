"""MusicXML -> Sinsy-style HTS full-context labels (host-side frontend), a
copy of the JAX package's ``frontend/musicxml.py`` over the port's
``io/hts.py``.

First-party replacement for the pysinsy dependency of NNSVS.  Parses a
(possibly compressed-less) MusicXML score with the stdlib ElementTree,
converts Japanese kana lyrics to Sinsy phonemes, and emits full-context
labels in the grammar the jp hed question sets expect
(recipes/_common/hed/jp_dev_latest.hed), so a score can drive the packed
models directly.

Grammar notes (fields verified against the nitech fixture labels):
  * quinphone + syllable positions: ``p1@p2^p3-p4+p5=p6_..-p12!p13[p14$p15]``
  * note blocks D/E/F (prev/current/next): absolute pitch name (d1/e1/f1),
    relative pitch e2 = (pitch class - key root) mod 12 with the root from
    the MusicXML key signature's fifths, note lengths in 10 ms (e7) and
    96th notes (e8), measure positions e10..e17, phrase positions
    e18..e25, and semitone deltas e57 = cur - prev / e58 = next - cur
    encoded ``p<n>`` / ``m<n>``.
  * Phrases split at rests; G/H/I carry (syllables, notes) of the
    previous/current/next phrase, J the song totals.
Fields the hed never queries are left ``xx``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import List, Optional

from ensemble_svs_with_interactions_tpu_torch.io import hts

HTS_FRAME = 50000  # 5 ms in 100 ns units
VOWELS = {"a", "i", "u", "e", "o", "A", "I", "U", "E", "O", "N", "cl"}

# --------------------------------------------------------------------------
# Japanese kana -> Sinsy phoneme table (standard romanization; covers the
# jaCappella / NEUTRINO lyric inventory)
# --------------------------------------------------------------------------

_BASE = {
    "あ": ["a"], "い": ["i"], "う": ["u"], "え": ["e"], "お": ["o"],
    "か": ["k", "a"], "き": ["k", "i"], "く": ["k", "u"], "け": ["k", "e"], "こ": ["k", "o"],
    "が": ["g", "a"], "ぎ": ["g", "i"], "ぐ": ["g", "u"], "げ": ["g", "e"], "ご": ["g", "o"],
    "さ": ["s", "a"], "し": ["sh", "i"], "す": ["s", "u"], "せ": ["s", "e"], "そ": ["s", "o"],
    "ざ": ["z", "a"], "じ": ["j", "i"], "ず": ["z", "u"], "ぜ": ["z", "e"], "ぞ": ["z", "o"],
    "た": ["t", "a"], "ち": ["ch", "i"], "つ": ["ts", "u"], "て": ["t", "e"], "と": ["t", "o"],
    "だ": ["d", "a"], "ぢ": ["j", "i"], "づ": ["z", "u"], "で": ["d", "e"], "ど": ["d", "o"],
    "な": ["n", "a"], "に": ["n", "i"], "ぬ": ["n", "u"], "ね": ["n", "e"], "の": ["n", "o"],
    "は": ["h", "a"], "ひ": ["h", "i"], "ふ": ["f", "u"], "へ": ["h", "e"], "ほ": ["h", "o"],
    "ば": ["b", "a"], "び": ["b", "i"], "ぶ": ["b", "u"], "べ": ["b", "e"], "ぼ": ["b", "o"],
    "ぱ": ["p", "a"], "ぴ": ["p", "i"], "ぷ": ["p", "u"], "ぺ": ["p", "e"], "ぽ": ["p", "o"],
    "ま": ["m", "a"], "み": ["m", "i"], "む": ["m", "u"], "め": ["m", "e"], "も": ["m", "o"],
    "や": ["y", "a"], "ゆ": ["y", "u"], "よ": ["y", "o"],
    "ら": ["r", "a"], "り": ["r", "i"], "る": ["r", "u"], "れ": ["r", "e"], "ろ": ["r", "o"],
    "わ": ["w", "a"], "を": ["o"], "ん": ["N"],
    "ゔ": ["v", "u"],
    "っ": ["cl"],
    "ー": [],  # long-vowel mark: repeat previous vowel
}
_YOUON = {
    "きゃ": ["ky", "a"], "きゅ": ["ky", "u"], "きょ": ["ky", "o"],
    "ぎゃ": ["gy", "a"], "ぎゅ": ["gy", "u"], "ぎょ": ["gy", "o"],
    "しゃ": ["sh", "a"], "しゅ": ["sh", "u"], "しょ": ["sh", "o"],
    "じゃ": ["j", "a"], "じゅ": ["j", "u"], "じょ": ["j", "o"],
    "ちゃ": ["ch", "a"], "ちゅ": ["ch", "u"], "ちょ": ["ch", "o"],
    "にゃ": ["ny", "a"], "にゅ": ["ny", "u"], "にょ": ["ny", "o"],
    "ひゃ": ["hy", "a"], "ひゅ": ["hy", "u"], "ひょ": ["hy", "o"],
    "びゃ": ["by", "a"], "びゅ": ["by", "u"], "びょ": ["by", "o"],
    "ぴゃ": ["py", "a"], "ぴゅ": ["py", "u"], "ぴょ": ["py", "o"],
    "みゃ": ["my", "a"], "みゅ": ["my", "u"], "みょ": ["my", "o"],
    "りゃ": ["ry", "a"], "りゅ": ["ry", "u"], "りょ": ["ry", "o"],
    "てぃ": ["ty", "i"], "でぃ": ["dy", "i"], "ふぁ": ["f", "a"],
    "ふぃ": ["f", "i"], "ふぇ": ["f", "e"], "ふぉ": ["f", "o"],
    "うぃ": ["w", "i"], "うぇ": ["w", "e"], "うぉ": ["w", "o"],
    "しぇ": ["sh", "e"], "ちぇ": ["ch", "e"], "じぇ": ["j", "e"],
    "つぁ": ["ts", "a"], "つぃ": ["ts", "i"], "つぇ": ["ts", "e"],
    "つぉ": ["ts", "o"], "とぅ": ["t", "u"], "どぅ": ["d", "u"],
    "てゅ": ["ty", "u"], "でゅ": ["dy", "u"], "いぇ": ["y", "e"],
    "ゔぁ": ["v", "a"], "ゔぃ": ["v", "i"], "ゔぇ": ["v", "e"],
    "ゔぉ": ["v", "o"], "ふゅ": ["hy", "u"],
}

# small kana not consumed by a _YOUON pair replace the previous vowel
# (e.g. an unlisted combo like ずぃ -> z+i); ゃ/ゅ/ょ degrade to their
# plain vowels
_SMALL_VOWEL = {
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o",
    "ゃ": "a", "ゅ": "u", "ょ": "o",
}


def _kata_to_hira(text: str) -> str:
    out = []
    for ch in text:
        o = ord(ch)
        out.append(chr(o - 0x60) if 0x30A1 <= o <= 0x30F6 else ch)
    return "".join(out)


def g2p_ja(lyric: str, prev_vowel: Optional[str] = None) -> List[str]:
    """Kana (or romaji phoneme string) -> Sinsy phonemes.

    A long-vowel mark repeats ``prev_vowel``; unknown ASCII tokens are
    passed through as phonemes (scores sometimes carry romaji directly).
    """
    from ensemble_svs_with_interactions_tpu_torch.frontend.ja import phonemes as INV

    text = _kata_to_hira(lyric.strip())
    if not text:
        return []
    if all(ord(c) < 128 for c in text):  # romaji / phoneme passthrough
        toks = text.split()
        if all(t in INV for t in toks):
            return toks
        text_l = text.lower()
        # naive romaji split: longest-match against the inventory
        out, i = [], 0
        while i < len(text_l):
            for ln in (2, 1):
                tok = text_l[i : i + ln]
                if tok in INV:
                    out.append(tok)
                    i += ln
                    break
            else:
                i += 1
        return out

    out: List[str] = []
    i = 0
    while i < len(text):
        pair = text[i : i + 2]
        if pair in _YOUON:
            out.extend(_YOUON[pair])
            i += 2
            continue
        ch = text[i]
        if ch == "ー":
            # repeat the previous true vowel ("cl" is not sustainable)
            v = next(
                (p for p in reversed(out) if p in VOWELS and p != "cl"),
                prev_vowel,
            )
            if v:
                out.append(v)
        elif ch in _SMALL_VOWEL and out and out[-1] in VOWELS and out[-1] != "cl":
            # unlisted small-kana combo: the small kana replaces the
            # preceding vowel (ちぇ -> ch+e, ゔぁ -> v+a, ...)
            out[-1] = _SMALL_VOWEL[ch]
        elif ch in _BASE:
            out.extend(_BASE[ch])
        i += 1
    return out


# --------------------------------------------------------------------------
# MusicXML parsing
# --------------------------------------------------------------------------


@dataclass
class ScoreNote:
    start: int          # 100 ns units
    duration: int       # 100 ns units
    midi: Optional[int]  # None = rest
    lyric: str = ""
    tempo: float = 100.0
    beats: int = 4
    beat_type: int = 4
    fifths: int = 0
    measure_index: int = 0
    measure_start: int = 0
    measure_duration: int = 0
    phonemes: List[str] = field(default_factory=list)


_STEP_PC = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
_PC_NAME = ["C", "Db", "D", "Eb", "E", "F", "Gb", "G", "Ab", "A", "Bb", "B"]


def midi_to_name(midi: int) -> str:
    return f"{_PC_NAME[midi % 12]}{midi // 12 - 1}"


def parse_musicxml(path) -> List[ScoreNote]:
    """Flatten the first part of a MusicXML score into timed notes.

    Handles divisions/tempo/time-signature changes, ties (merged into one
    note) and rests.  Times are in 100 ns units, snapped to the 5 ms HTS
    frame grid.
    """
    root = ET.parse(path if hasattr(path, "read") else str(path)).getroot()
    part = root.find("part")
    if part is None:
        raise ValueError("no <part> in MusicXML")

    divisions = 1
    tempo = 100.0
    beats, beat_type = 4, 4
    fifths = 0
    t = 0  # 100 ns
    notes: List[ScoreNote] = []
    measure_meta = []  # (index, start, duration)

    for mi, measure in enumerate(part.findall("measure")):
        m_start = t
        for el in measure:
            if el.tag == "attributes":
                if el.find("divisions") is not None:
                    divisions = int(el.find("divisions").text)
                time_el = el.find("time")
                if time_el is not None:
                    beats = int(time_el.find("beats").text)
                    beat_type = int(time_el.find("beat-type").text)
                key_el = el.find("key")
                if key_el is not None and key_el.find("fifths") is not None:
                    fifths = int(key_el.find("fifths").text)
            elif el.tag == "direction":
                for s in el.iter("sound"):
                    if s.get("tempo"):
                        tempo = float(s.get("tempo"))
            elif el.tag == "sound" and el.get("tempo"):
                tempo = float(el.get("tempo"))
            elif el.tag == "note":
                if el.find("grace") is not None:
                    continue
                dur_div = int(el.find("duration").text)
                # one division = one quarter/divisions; quarter = 60/tempo s
                sec = dur_div / divisions * 60.0 / tempo
                dur = int(round(sec * 1e7 / HTS_FRAME)) * HTS_FRAME
                if el.find("chord") is not None:
                    continue  # keep the first chord note only
                pitch_el = el.find("pitch")
                if el.find("rest") is not None or pitch_el is None:
                    midi = None
                else:
                    step = pitch_el.find("step").text
                    alter = int(float(pitch_el.find("alter").text)) if (
                        pitch_el.find("alter") is not None
                    ) else 0
                    octave = int(pitch_el.find("octave").text)
                    midi = 12 * (octave + 1) + _STEP_PC[step] + alter
                lyric_el = el.find("lyric/text")
                lyric = lyric_el.text if lyric_el is not None and lyric_el.text else ""
                tie_types = {
                    tie.get("type") for tie in el.findall("tie")
                } | {
                    tt.get("type") for tt in el.findall("notations/tied")
                }
                extends_prev = (
                    notes
                    and notes[-1].midi == midi
                    and midi is not None
                    and ("stop" in tie_types)
                    and notes[-1].start + notes[-1].duration == t
                )
                if extends_prev and not lyric:
                    notes[-1].duration += dur
                elif (
                    notes
                    and notes[-1].midi is None
                    and midi is None
                    and notes[-1].start + notes[-1].duration == t
                ):
                    notes[-1].duration += dur  # merge adjacent rests
                else:
                    notes.append(
                        ScoreNote(
                            start=t, duration=dur, midi=midi, lyric=lyric,
                            tempo=tempo, beats=beats, beat_type=beat_type,
                            fifths=fifths, measure_index=mi,
                            measure_start=m_start,
                        )
                    )
                t += dur
            elif el.tag == "backup":
                dur_div = int(el.find("duration").text)
                sec = dur_div / divisions * 60.0 / tempo
                t -= int(round(sec * 1e7 / HTS_FRAME)) * HTS_FRAME
            elif el.tag == "forward":
                dur_div = int(el.find("duration").text)
                sec = dur_div / divisions * 60.0 / tempo
                t += int(round(sec * 1e7 / HTS_FRAME)) * HTS_FRAME
        measure_meta.append((mi, m_start, t - m_start))

    durs = {mi: d for mi, s, d in measure_meta}
    for n in notes:
        n.measure_duration = durs.get(n.measure_index, 0)
    return notes


# --------------------------------------------------------------------------
# label generation
# --------------------------------------------------------------------------


def _pm(delta: int) -> str:
    return ("p" if delta >= 0 else "m") + str(abs(int(delta)))


def _note_block(n: Optional[ScoreNote]):
    """(pitch_name, rel_pitch, n_syllables, len_10ms, len_96th) or xx's."""
    if n is None or n.midi is None:
        return "xx", "xx", "xx", "xx", "xx"
    root = (7 * n.fifths) % 12
    rel = (n.midi - root) % 12
    len_10ms = int(round(n.duration / 1e5))
    quarter_100ns = 60.0 / n.tempo * 1e7
    len_96 = int(round(n.duration / quarter_100ns * 24))
    return midi_to_name(n.midi), str(rel), "1", str(len_10ms), str(len_96)


def _phone_kind(ph: str) -> str:
    if ph in ("sil", "pau"):
        return "p"
    if ph in ("a", "i", "u", "e", "o", "A", "I", "U", "E", "O", "N"):
        return "v"
    if ph == "br":
        return "b"
    if ph == "cl":
        return "b"
    return "c"


def notes_to_labels(notes: List[ScoreNote]) -> hts.HTSLabels:
    """Timed, phonemized notes -> full-context HTS labels."""
    # --- phonemize, track phrase boundaries (rests) ------------------------
    prev_vowel = None
    for n in notes:
        if n.midi is None:
            n.phonemes = ["pau"]
        else:
            # a frontend may pre-phonemize (e.g. frontend.ust through an
            # ENUNU kana2phonemes.table); only fill what is empty
            phs = n.phonemes or g2p_ja(n.lyric, prev_vowel)
            if not phs:
                phs = [prev_vowel or "a"]  # melisma continues the vowel
            n.phonemes = phs
            pv = [p for p in phs if p in VOWELS and p != "cl"]
            if pv:
                prev_vowel = pv[-1]

    # score-label convention: every phone of a note carries the NOTE's
    # start/end times — note boundaries are recovered from start-time
    # changes (io/hts.get_note_indices; see the reference NEUTRINO full
    # labels, tests/data/neutrino/sample1_full.lab)
    entries = []  # (phone, note_idx, start, dur)
    for ni, n in enumerate(notes):
        for ph in n.phonemes:
            entries.append([ph, ni, n.start, n.duration])

    # --- phrase segmentation (rests separate phrases) ----------------------
    phrase_of_note = {}
    phrases = []  # list of [note indices]
    cur = []
    for ni, n in enumerate(notes):
        if n.midi is None:
            if cur:
                phrases.append(cur)
                cur = []
        else:
            cur.append(ni)
    if cur:
        phrases.append(cur)
    for pi, idxs in enumerate(phrases):
        for ni in idxs:
            phrase_of_note[ni] = pi

    def phrase_stats(pi):
        if pi < 0 or pi >= len(phrases):
            return "xx", "xx"
        idxs = phrases[pi]
        n_syl = sum(1 for ni in idxs)  # one syllable per note (melismas too)
        return str(n_syl), str(len(idxs))

    total_syl = sum(1 for n in notes if n.midi is not None)
    n_measures = max((n.measure_index for n in notes), default=-1) + 1

    # measure note counts for e10/e11 — padding silence (measure_index
    # -1) belongs to no measure and must not shift positions
    notes_in_measure = {}
    for n in notes:
        if n.measure_index < 0:
            continue
        notes_in_measure.setdefault(n.measure_index, 0)
        notes_in_measure[n.measure_index] += 1
    pos_in_measure = {}
    seen = {}
    for ni, n in enumerate(notes):
        if n.measure_index < 0:
            continue
        seen.setdefault(n.measure_index, 0)
        seen[n.measure_index] += 1
        pos_in_measure[ni] = seen[n.measure_index]

    labels = hts.HTSLabels(frame_shift=HTS_FRAME)
    phones = [e[0] for e in entries]

    def ph_at(i):
        return phones[i] if 0 <= i < len(phones) else "xx"

    seen_in_note: dict = {}
    for ei, (ph, ni, start, dur) in enumerate(entries):
        n = notes[ni]
        note_phs = n.phonemes
        pi_in_note = seen_in_note.get(ni, 0)
        seen_in_note[ni] = pi_in_note + 1
        n_in_note = len(note_phs)

        # syllable = the phones of this note (sinsy: one syllable per note
        # in melisma-free kana scores)
        p12, p13 = str(pi_in_note + 1), str(n_in_note - pi_in_note)
        # consonant<->vowel distances within the syllable
        vowel_pos = next(
            (k for k, p in enumerate(note_phs) if p in VOWELS), None
        )
        p14 = p15 = "xx"
        if vowel_pos is not None and ph not in ("sil", "pau"):
            if pi_in_note < vowel_pos:
                p15 = str(vowel_pos - pi_in_note)
            elif pi_in_note > vowel_pos:
                p14 = str(pi_in_note - vowel_pos)

        prev_note = notes[ni - 1] if ni > 0 else None
        next_note = notes[ni + 1] if ni + 1 < len(notes) else None
        d1, d2, d6, d7, d8 = _note_block(prev_note)
        f1, f2, f6, f7, f8 = _note_block(next_note)

        beat = f"{n.beats}/{n.beat_type}"
        tempo = str(int(round(n.tempo)))
        quarter = 60.0 / n.tempo * 1e7

        # pitch contexts (e1/e2) only exist for voiced notes; the key
        # (e3), length (e6-e8) and measure-position (e10-e17) contexts
        # are populated for rests too — Sinsy/NEUTRINO labels carry them
        # on pau (fixture nitech_jp_song070_f001_004.lab: /E:xx]xx^11=2/4
        # ~100!1@120#48+xx]1$1|0[12&0]48=0^100), and heds query e6-e17
        if n.midi is not None:
            e1, e2, _, _, _ = _note_block(n)
        else:
            e1 = e2 = "xx"
        e3 = str((7 * n.fifths) % 12)  # key number from circle of fifths
        e6 = "1"
        e7 = str(int(round(n.duration / 1e5)))
        e8 = str(int(round(n.duration / quarter * 24)))

        if n.measure_index >= 0:
            e10 = str(pos_in_measure[ni])
            e11 = str(notes_in_measure[n.measure_index] - pos_in_measure[ni] + 1)
            off = n.start - n.measure_start
            mlen = max(n.measure_duration, 1)
        else:
            # padding silence: its own single-note span (pysinsy conv.)
            e10 = e11 = "1"
            off, mlen = 0, max(n.duration, 1)
        e12 = str(int(off / 1e6))          # 100 ms units (fixture conv.)
        e13 = str(int((mlen - off) / 1e6))
        e14 = str(int(round(off / quarter * 24)))
        e15 = str(int(round((mlen - off) / quarter * 24)))
        e16 = str(int(round(off / mlen * 100)))
        e17 = str(100 - int(round(off / mlen * 100)))

        if n.midi is not None:
            pidx = phrase_of_note.get(ni)
            idxs = phrases[pidx]
            k = idxs.index(ni)
            e18, e19 = str(k + 1), str(len(idxs) - k)
            ph_start = notes[idxs[0]].start
            ph_end = notes[idxs[-1]].start + notes[idxs[-1]].duration
            ph_len = max(ph_end - ph_start, 1)
            e20 = str(int((n.start - ph_start) / 1e6))
            e21 = str(int((ph_end - n.start) / 1e6))
            e22 = str(int(round((n.start - ph_start) / quarter * 24)))
            e23 = str(int(round((ph_end - n.start) / quarter * 24)))
            e24 = str(int(round((n.start - ph_start) / ph_len * 100)))
            e25 = str(100 - int(round((n.start - ph_start) / ph_len * 100)))
            e57 = (
                _pm(n.midi - prev_note.midi)
                if prev_note is not None and prev_note.midi is not None
                else "xx"
            )
            e58 = (
                _pm(next_note.midi - n.midi)
                if next_note is not None and next_note.midi is not None
                else "xx"
            )
        else:
            e18 = e19 = e20 = e21 = e22 = e23 = e24 = e25 = "xx"
            e57 = e58 = "xx"

        # previous / current / next phrase stats
        pidx = phrase_of_note.get(ni, None)
        if pidx is None:
            # rest: phrase context = surrounding phrases
            left = phrase_of_note.get(ni - 1, -1)
            g = phrase_stats(left)
            h = ("xx", "xx")
            i_ = phrase_stats(left + 1)
        else:
            g = phrase_stats(pidx - 1)
            h = phrase_stats(pidx)
            i_ = phrase_stats(pidx + 1)

        b1 = str(n_in_note) if ph not in ("sil", "pau") else "1"
        sylB = f"/B:{b1}_1_1@JPN|0" if ph not in ("sil", "pau") else "/B:1_1_1@xx|xx"
        prev_b = notes[ni - 1] if ni > 0 else None
        next_b = notes[ni + 1] if ni + 1 < len(notes) else None
        a1 = str(len(prev_b.phonemes)) if prev_b and prev_b.midi is not None else "xx"
        c1 = str(len(next_b.phonemes)) if next_b and next_b.midi is not None else "xx"

        ctx = (
            f"{_phone_kind(ph)}@{ph_at(ei - 2)}^{ph_at(ei - 1)}-{ph}+"
            f"{ph_at(ei + 1)}={ph_at(ei + 2)}"
            f"_xx%xx^xx_xx~xx-{p12}!{p13}[{p14}${p15}]xx"
            f"/A:{a1}-xx-xx@xx~xx"
            f"{sylB}"
            f"/C:{c1}+xx+xx@JPN&xx"
            f"/D:{d1}!{d2}#xx${beat}%{tempo}|{d6}&{d7};{d8}-xx"
            f"/E:{e1}]{e2}^{e3}={beat}~{tempo}!{e6}@{e7}#{e8}+xx"
            f"]{e10}${e11}|{e12}[{e13}&{e14}]{e15}={e16}^{e17}"
            f"~{e18}#{e19}_{e20};{e21}${e22}&{e23}%{e24}[{e25}"
            f"|xx]xx-xx^xx+xx~xx=xx@xx$xx!xx%xx#xx|xx|xx-xx"
            f"&xx&xx+xx[xx;xx]xx;xx~xx~xx^xx^xx@xx[xx#xx=xx!xx"
            f"~{e57}+{e58}!xx^xx"
            f"/F:{f1}#{f2}#xx-{beat}${tempo}${f6}+{f7}%{f8};xx"
            f"/G:{g[0]}_{g[1]}"
            f"/H:{h[0]}_{h[1]}"
            f"/I:{i_[0]}_{i_[1]}"
            f"/J:{len(phrases)}~{total_syl}@{n_measures}"
        )
        labels.append((start, start + dur, ctx), strict=False)
    return labels


def musicxml_to_labels(path) -> hts.HTSLabels:
    """Parse a MusicXML score into full-context labels, with 0.5 s of
    leading/trailing silence (pysinsy-style padding)."""
    return score_to_labels(parse_musicxml(path), origin=path)


def score_to_labels(notes: List[ScoreNote], origin="score") -> hts.HTSLabels:
    """Timed notes (any score frontend) -> padded full-context labels."""
    if not notes:
        raise ValueError(f"no notes parsed from {origin}")
    pad = int(0.5e7 // HTS_FRAME) * HTS_FRAME
    if notes[0].midi is not None or notes[0].start > 0:
        # the pad rest must also absorb any leading score offset (e.g. a
        # <forward> before the first note) so labels stay contiguous:
        # cover [0, first_start + pad), not just [0, pad)
        lead = int(notes[0].start)
        for n in notes:
            n.start += pad
            n.measure_start += pad
        # padding silence belongs to no measure (pysinsy likewise) —
        # measure_index -1 keeps it out of the e10/e11 note counts
        notes.insert(
            0,
            ScoreNote(start=0, duration=pad + lead, midi=None,
                      tempo=notes[0].tempo, beats=notes[0].beats,
                      beat_type=notes[0].beat_type,
                      fifths=notes[0].fifths,
                      measure_index=-1),
        )
    last = notes[-1]
    if last.midi is not None:
        notes.append(
            ScoreNote(start=last.start + last.duration, duration=pad,
                      midi=None, tempo=last.tempo, beats=last.beats,
                      beat_type=last.beat_type,
                      fifths=last.fifths,
                      measure_index=-1)
        )
    return notes_to_labels(notes)
