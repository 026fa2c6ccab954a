"""First-party HTS full-context label I/O and utilities.

A copy of ``ensemble_svs_with_interactions_tpu/io/hts.py`` (the port
imports nothing of the JAX package).

Replaces the reference's use of ``nnmnkwii.io.hts`` (HTSLabelFile /
load_question_set) and re-provides the label utilities of the reference's
``nnsvs/io/hts.py`` (full_to_mono, note indices, merge_sil, segment_labels,
NEUTRINO phrase segmentation) with fresh, NumPy-first implementations.

Time unit convention follows HTS: 100 ns units (1e-7 s).  The default frame
shift of 50000 units = 5 ms.

Reference parity targets (upstream nnsvs):
  * label parsing            -> nnmnkwii.io.hts.HTSLabelFile (external dep)
  * question-set parsing     -> nnmnkwii.io.hts.load_question_set
  * full_to_mono             -> nnsvs/io/hts.py:10
  * get_pitch_index(es)      -> nnsvs/io/hts.py:48,68
  * get_note_indices         -> nnsvs/io/hts.py:95
  * get_note_frame_indices   -> nnsvs/io/hts.py:29
  * merge_sil                -> nnsvs/io/hts.py:115
  * segment_labels           -> nnsvs/io/hts.py:165
  * label2phrases(_str)      -> nnsvs/io/hts.py:341,367
  * overwrite_phoneme_flags_ -> nnsvs/io/hts.py:386
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterator, List, Sequence, Tuple

import numpy as np

# 100ns units per second
HTS_TIME_UNITS_PER_SEC = int(1e7)
DEFAULT_FRAME_SHIFT = 50000  # 5 ms in 100 ns units

_PHONE_FLAG_RE = re.compile(r"\^([A-Za-z0-9]+)\_")


@dataclass
class HTSLabels:
    """A sequence of (start, end, context) HTS label entries.

    ``start_times`` / ``end_times`` are int arrays in 100 ns units.
    ``contexts`` are the raw (full-context or mono) label strings.
    """

    start_times: List[int] = field(default_factory=list)
    end_times: List[int] = field(default_factory=list)
    contexts: List[str] = field(default_factory=list)
    frame_shift: int = DEFAULT_FRAME_SHIFT

    # ------------------------------------------------------------------ core
    def __len__(self) -> int:
        return len(self.contexts)

    def __iter__(self) -> Iterator[Tuple[int, int, str]]:
        return iter(zip(self.start_times, self.end_times, self.contexts))

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return HTSLabels(
                list(self.start_times[idx]),
                list(self.end_times[idx]),
                list(self.contexts[idx]),
                self.frame_shift,
            )
        if isinstance(idx, (list, np.ndarray)):
            return HTSLabels(
                [self.start_times[int(i)] for i in idx],
                [self.end_times[int(i)] for i in idx],
                [self.contexts[int(i)] for i in idx],
                self.frame_shift,
            )
        return (self.start_times[idx], self.end_times[idx], self.contexts[idx])

    def append(self, entry: Tuple[int, int, str], strict: bool = True) -> "HTSLabels":
        s, e, c = int(entry[0]), int(entry[1]), str(entry[2])
        if strict:
            if s >= e:
                raise ValueError(f"end time must exceed start time: {entry}")
            if self.end_times and s != self.end_times[-1]:
                raise ValueError(
                    f"label must start where the previous ended: {entry}"
                )
        self.start_times.append(s)
        self.end_times.append(e)
        self.contexts.append(c)
        return self

    def copy(self) -> "HTSLabels":
        return HTSLabels(
            list(self.start_times),
            list(self.end_times),
            list(self.contexts),
            self.frame_shift,
        )

    # ----------------------------------------------------------------- views
    def is_full_context(self) -> bool:
        return "@" in self.contexts[0]

    def is_state_alignment(self) -> bool:
        """True for HMM state-level alignment labels (``...[k]`` suffix).

        Same detection rule as nnmnkwii's ``is_state_alignment_label``
        (reference dependency): the first context ends with a bracketed
        single-digit state index.
        """
        c = self.contexts[0]
        return len(c) >= 3 and c[-1] == "]" and c[-3] == "["

    def num_frames(self, frame_shift: int | None = None) -> int:
        fs = int(frame_shift or self.frame_shift)
        return int(self.end_times[-1] / fs) - int(self.start_times[0] / fs)

    def num_phones(self) -> int:
        return len(self)

    def phone_durations(self, frame_shift: int | None = None) -> np.ndarray:
        """Per-phone durations in frames (rounded like HTS: floor of each end)."""
        fs = int(frame_shift or self.frame_shift)
        s = np.asarray(self.start_times) // fs
        e = np.asarray(self.end_times) // fs
        return (e - s).astype(np.int64)

    def silence_phone_indices(self, regex: str = r"sil") -> np.ndarray:
        pat = re.compile(regex)
        if self.is_full_context():
            monos = [_center_phone(c) for c in self.contexts]
        else:
            monos = self.contexts
        return np.asarray(
            [i for i, m in enumerate(monos) if pat.fullmatch(m)], dtype=np.int64
        )

    def round_(self, frame_shift: int | None = None) -> "HTSLabels":
        """Round start/end times to multiples of the frame shift (in place)."""
        fs = int(frame_shift or self.frame_shift)
        self.start_times = [int(round(s / fs) * fs) for s in self.start_times]
        self.end_times = [int(round(e / fs) * fs) for e in self.end_times]
        return self

    def __str__(self) -> str:
        return "\n".join(
            f"{s} {e} {c}" for s, e, c in zip(
                self.start_times, self.end_times, self.contexts
            )
        )

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(str(self) + "\n")


def _center_phone(full_context: str) -> str:
    """Extract the center phoneme from a full-context label string."""
    try:
        return full_context.split("-")[1].split("+")[0]
    except IndexError:
        return full_context


def load(path) -> HTSLabels:
    """Load an HTS label file.

    Accepts both aligned labels (``start end context``) and score labels
    with no times (``context`` only, times set to 0).
    """
    with open(path) as f:
        return loads(f.read())


def loads(text: str) -> HTSLabels:
    labels = HTSLabels()
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        cols = line.split()
        if len(cols) >= 3:
            labels.start_times.append(int(cols[0]))
            labels.end_times.append(int(cols[1]))
            labels.contexts.append(" ".join(cols[2:]))
        else:
            labels.start_times.append(0)
            labels.end_times.append(0)
            labels.contexts.append(cols[-1])
    return labels


# --------------------------------------------------------------------------
# Question sets (hed files)
# --------------------------------------------------------------------------

_NOTE_RE = "([A-Z][b#]?[0-9]+)"


def _hts_wildcard_to_regex(pattern: str, numeric: bool = False) -> str:
    """Convert an HTS-style wildcard question pattern to a Python regex.

    ``*`` is a wildcard.  For numeric (CQS) questions the capture-group
    placeholders ``(\\d+)``, ``([-\\d]+)``, ``(\\NOTE)`` and ``([pm]\\d+)``
    are kept as live regex groups; everything else is escaped literally.
    """
    anchored_start = not pattern.startswith("*")
    anchored_end = not pattern.endswith("*")
    body = pattern.strip("*")
    out = re.escape(body)
    out = out.replace(re.escape("*"), ".*")
    if numeric:
        # un-escape the supported capture group syntaxes
        replacements = {
            re.escape("(\\d+)"): r"(\d+)",
            re.escape("([-\\d]+)"): r"([\-\d]+)",
            re.escape("([\\-\\d]+)"): r"([\-\d]+)",
            # nnmnkwii-documented decimal capture (frontend/merlin.py
            # wildcards2regex converts ([\d\.]+) too)
            re.escape("([\\d\\.]+)"): r"([\d\.]+)",
            re.escape("([\\d.]+)"): r"([\d\.]+)",
            re.escape("(\\NOTE)"): _NOTE_RE,
            re.escape("([A-Z][b#]?[0-9]+)"): _NOTE_RE,
            re.escape("([pm]\\d+)"): r"([pm]\d+)",
        }
        for k, v in replacements.items():
            out = out.replace(k, v)
    if "*" in pattern:
        if anchored_start:
            out = r"\A" + out
        if anchored_end:
            out = out + r"\Z"
    return out


def load_question_set(path):
    """Parse an HTS .hed question file.

    Returns ``(binary_dict, numeric_dict)`` where
    ``binary_dict[i] = (name, [compiled_regex, ...])`` for QS entries and
    ``numeric_dict[i] = (name, compiled_regex)`` for CQS entries — the same
    structure the reference consumes via nnmnkwii
    (see nnsvs/io/hts.py:48-92 usage).
    """
    binary_dict = {}
    numeric_dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = re.match(r"^(QS|CQS)\s+\"([^\"]+)\"\s*\{(.*)\}\s*$", line)
            if m is None:
                continue
            kind, name, body = m.group(1), m.group(2), m.group(3)
            patterns = [p.strip() for p in body.split(",") if p.strip()]
            if kind == "QS":
                regexes = [
                    re.compile(_hts_wildcard_to_regex(p, numeric=False))
                    for p in patterns
                ]
                binary_dict[len(binary_dict)] = (name, regexes)
            else:
                if len(patterns) != 1:
                    raise ValueError(f"CQS must have exactly one pattern: {line}")
                regex = re.compile(_hts_wildcard_to_regex(patterns[0], numeric=True))
                numeric_dict[len(numeric_dict)] = (name, regex)
    return binary_dict, numeric_dict


_NOTE_NAMES = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


def note_name_to_midi(note: str) -> float:
    """Convert a note name like ``E4`` / ``Db5`` / ``C#3`` to a MIDI number."""
    m = re.match(r"^([A-G])([b#]?)([0-9]+)$", note)
    if m is None:
        return -1.0
    semitone = _NOTE_NAMES[m.group(1)]
    if m.group(2) == "#":
        semitone += 1
    elif m.group(2) == "b":
        semitone -= 1
    octave = int(m.group(3))
    return float(12 * (octave + 1) + semitone)


def numeric_feature_value(match_text: str) -> float:
    """Decode a CQS capture: plain int, note name, or p/m signed offset."""
    if re.match(r"^[\-\d]+$", match_text):
        return float(match_text)
    if match_text.startswith("p") and match_text[1:].isdigit():
        return float(match_text[1:])
    if match_text.startswith("m") and match_text[1:].isdigit():
        return -float(match_text[1:])
    midi = note_name_to_midi(match_text)
    return midi


# --------------------------------------------------------------------------
# Label utilities (parity with reference nnsvs/io/hts.py)
# --------------------------------------------------------------------------


def full_to_mono(labels: HTSLabels) -> HTSLabels:
    """Strip full-context labels down to center phonemes."""
    if not labels.is_full_context():
        return labels
    out = labels.copy()
    out.contexts = [_center_phone(c) for c in labels.contexts]
    return out


def get_pitch_index(binary_dict, numeric_dict) -> int:
    """Index of the first ``/E`` (current-note absolute pitch) numeric feature
    in the concatenated [binary | numeric] linguistic feature vector."""
    base = len(binary_dict)
    for idx in range(len(numeric_dict)):
        if numeric_dict[idx][1].pattern.startswith("/E"):
            return base + idx
    return base


def get_pitch_indices(binary_dict, numeric_dict) -> List[int]:
    """Indices of the leading /D,/E,/F absolute-pitch numeric features."""
    base = len(binary_dict)
    if not any(
        numeric_dict[0][1].pattern.startswith(p) for p in ("/D", "/E", "/F")
    ):
        raise ValueError("first numeric question must be an absolute pitch feature")
    indices = [base]
    idx = 1
    while idx < len(numeric_dict) and any(
        numeric_dict[idx][1].pattern.startswith(p) for p in ("/D", "/E", "/F")
    ):
        indices.append(base + idx)
        idx += 1
    return indices


def get_note_indices(labels: HTSLabels) -> List[int]:
    """Indices of phones that begin a new note (detected by start-time change)."""
    out = [0]
    prev = labels.start_times[0]
    for i in range(1, len(labels)):
        if labels.start_times[i] != prev:
            out.append(i)
            prev = labels.start_times[i]
    return out


def get_note_frame_indices(binary_dict, numeric_dict, in_feats: np.ndarray):
    """Frame indices whose score F0 (discrete, at the pitch index) is > 0."""
    pitch_idx = get_pitch_index(binary_dict, numeric_dict)
    return np.where(in_feats[:, pitch_idx] > 0)[0]


def is_silence_context(context: str) -> bool:
    if "@" in context:
        return ("-sil" in context) or ("-pau" in context)
    return context in ("sil", "pau")


def is_br_context(context: str) -> bool:
    if "@" in context:
        return "-br" in context
    return context == "br"


def merge_sil(labels: HTSLabels) -> HTSLabels:
    """Merge runs of consecutive silence (sil) labels into one."""
    out = HTSLabels(frame_shift=labels.frame_shift)
    out.append(labels[0], strict=False)
    full = labels.is_full_context()
    for i in range(1, len(labels)):
        prev_sil = ("-sil" in out.contexts[-1]) if full else out.contexts[-1] == "sil"
        cur_sil = ("-sil" in labels.contexts[i]) if full else labels.contexts[i] == "sil"
        if prev_sil and cur_sil:
            out.end_times[-1] = labels.end_times[i]
        else:
            out.append(labels[i], strict=False)
    return out


def compute_nosil_duration(labels: HTSLabels, threshold: float = 5.0) -> float:
    """Total duration in seconds, excluding silences longer than threshold."""
    total = 0.0
    for s, e, c in labels:
        d = (e - s) * 1e-7
        if is_silence_context(c) and d > threshold:
            continue
        total += d
    return total


def segment_labels(
    labels: HTSLabels,
    strict: bool = True,
    silence_threshold: float = 0.1,
    min_duration: float = 5.0,
    force_split_threshold: float = 5.0,
) -> List[HTSLabels]:
    """Split long utterances into segments at sil/pau boundaries.

    Behavioral contract mirrors nnsvs/io/hts.py:165-254:
    split where a silence exceeds ``silence_threshold`` AND the running
    segment is at least ``min_duration`` long (non-silence time), or
    unconditionally where a silence exceeds ``force_split_threshold`` (the
    long silence then becomes its own segment).  Short trailing segments are
    merged into the previous one.  Segment times are re-based to zero.
    """
    seg = HTSLabels(frame_shift=labels.frame_shift)
    start_indices: List[int] = []
    end_indices: List[int] = []
    si = 0
    done_last = False

    for idx, (s, e, c) in enumerate(labels):
        d = (e - s) * 1e-7
        silence = is_silence_context(c)
        seg_d = compute_nosil_duration(seg) if len(seg) > 0 else 0.0

        force = silence and d > force_split_threshold
        normal = silence and d > silence_threshold and seg_d > min_duration
        if force or normal:
            if idx == len(labels) - 1:
                pass
            elif len(seg) > 0:
                start_indices.append(si)
                if force:
                    end_indices.append(idx - 1)
                    start_indices.append(idx)
                    end_indices.append(idx)
                    seg = HTSLabels(frame_shift=labels.frame_shift)
                else:
                    seg.append((s, e, c), strict)
                    end_indices.append(idx)
                    seg = HTSLabels(frame_shift=labels.frame_shift)
                si = idx + 1
            else:
                seg.append((s, e, c), strict)
                start_indices.append(si)
                end_indices.append(idx)
                seg = HTSLabels(frame_shift=labels.frame_shift)
        else:
            if len(seg) == 0:
                si = idx
            if idx == len(labels) - 1:
                done_last = True
            seg.append((s, e, c), strict)

    if len(seg) > 0:
        seg_d = compute_nosil_duration(seg)
        if seg_d < min_duration and len(end_indices) > 1:
            end_indices[-1] = si + len(seg) - 1
        else:
            start_indices.append(si)
            end_indices.append(si + len(seg) - 1)
        if not done_last:
            s, e, c = labels[-1]
            if is_silence_context(c) and (e - s) * 1e-7 > silence_threshold:
                start_indices.append(end_indices[-1])
                end_indices.append(end_indices[-1])

    segments = []
    for s_i, e_i in zip(start_indices, end_indices):
        piece = labels[s_i : e_i + 1]
        offset = piece.start_times[0]
        piece.start_times = [t - offset for t in piece.start_times]
        piece.end_times = [t - offset for t in piece.end_times]
        segments.append(piece)
    return segments


# --------------------------------------------------------------------------
# NEUTRINO-style phrase segmentation
# --------------------------------------------------------------------------


def _phrase_boundaries(labels: HTSLabels):
    """Alternating silence/voiced phrase boundaries (NEUTRINO semantics;
    reference: nnsvs/io/hts.py:257-307)."""
    start_indices = [0]
    end_indices: List[int] = []
    in_sil_phrase = is_silence_context(labels.contexts[0])

    for idx, c in enumerate(labels.contexts):
        if in_sil_phrase:
            if is_silence_context(c):
                continue
        else:
            prev_is_br = idx > 0 and is_br_context(labels.contexts[idx - 1])
            if not is_silence_context(c) and not prev_is_br:
                continue
        end_indices.append(idx)
        in_sil_phrase = is_silence_context(c)
        start_indices.append(idx)

    if len(end_indices) == len(start_indices) - 1:
        end_indices.append(len(labels))
    return start_indices, end_indices


def fix_label_offset_to_zero(labels: HTSLabels) -> HTSLabels:
    offset = labels.start_times[0]
    if offset > 0:
        labels.start_times = [t - offset for t in labels.start_times]
        labels.end_times = [t - offset for t in labels.end_times]
    return labels


def label2phrases(labels: HTSLabels, fix_offset: bool = True) -> List[HTSLabels]:
    starts, ends = _phrase_boundaries(labels)
    phrases = [labels[s:e] for s, e in zip(starts, ends)]
    if fix_offset:
        phrases = [fix_label_offset_to_zero(p) for p in phrases]
    return phrases


def label2phrases_str(labels: HTSLabels, note_indices: Sequence[int]) -> str:
    """Emit a NEUTRINO-format phraselist text."""
    starts, ends = _phrase_boundaries(labels)
    note_set = set(note_indices) if note_indices is not None else None
    lines = []
    for idx, (s, e) in enumerate(zip(starts, ends)):
        if s == e:
            ph = labels.contexts[s]
        elif note_set is None:
            ph = " ".join(labels.contexts[s:e])
        else:
            toks = []
            for i in range(s, e):
                if i not in (s, e) and i in note_set:
                    toks.append(",")
                toks.append(labels.contexts[i])
            ph = " ".join(toks).replace(" ,", ",")
        start_time = int(labels.start_times[s] // 10000)
        voiced = not ("sil" in ph or "pau" in ph)
        lines.append(f"{idx} {start_time} {int(voiced)} {ph}")
    return "\n".join(lines) + "\n" if lines else ""


def overwrite_phoneme_flags_(labels: HTSLabels, flag: str) -> HTSLabels:
    """Rewrite the ``^FLAG_`` phoneme-flag field in every context string."""
    for i, c in enumerate(labels.contexts):
        n = len(_PHONE_FLAG_RE.findall(c))
        if n == 0:
            continue
        if n != 1:
            raise RuntimeError(f"more than one phoneme flag found: {c}")
        labels.contexts[i] = _PHONE_FLAG_RE.sub(f"^{flag}_", c)
    return labels
