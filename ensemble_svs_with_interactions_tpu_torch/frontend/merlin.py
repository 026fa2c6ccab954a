"""Merlin-style linguistic feature extraction from HTS labels.

A copy of ``ensemble_svs_with_interactions_tpu/frontend/merlin.py`` with
its imports pointed at this package.

First-party replacement for ``nnmnkwii.frontend.merlin`` (an external Cython/
NumPy dependency of the reference; used at
nnsvs/data/data_source.py:96-103 and
nnsvs/gen.py:108-115).

Produces, per phone (or per frame when ``add_frame_features=True``):
  [binary QS answers | numeric CQS answers | optional subphone features]

The dev question set yields 50 binary + 32 numeric = 82 phone-level dims, and
86 frame-level dims with ``subphone_features="coarse_coding"`` (3 coarse-coded
position features + 1 frame-count feature), matching
recipes/_common/hed/jp_dev_latest.hed:1-5 in the reference.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.io.hts import (
    HTSLabels,
    numeric_feature_value,
)


def normalize_subphone_features(mode) -> Optional[str]:
    """Canonicalize a subphone-feature mode from configs: YAML ``none``
    arrives as the string "none" (and ``null`` as real None) — both mean
    "no subphone features"."""
    if mode is None:
        return None
    mode = str(mode).strip()
    if mode.lower() in ("none", "null", ""):
        return None
    return mode


def get_frame_feature_size(subphone_features: Optional[str] = None) -> int:
    subphone_features = normalize_subphone_features(subphone_features)
    if subphone_features is None:
        return 0
    sp = subphone_features.strip().lower()
    sizes = {
        "full": 9,
        "state_only": 1,
        "frame_only": 1,
        "uniform_state": 2,
        "minimal_frame": 2,
        "minimal_phoneme": 3,
        "coarse_coding": 4,
    }
    if sp not in sizes:
        raise ValueError(f"unknown subphone feature type: {subphone_features}")
    return sizes[sp]


# Phone-level question answers depend only on the context string, and the
# same contexts are featurized several times per synthesis (timelag +
# duration at phone level, then the acoustic frame features after timing
# modification — durations change, context strings don't).  Memoize per
# question set; the registry keeps a strong reference to the question-set
# objects so id() keys can never be recycled.
_ANSWER_CACHE: dict = {}
_ANSWER_CACHE_MAX = 65536


def _phone_answers(binary_dict, numeric_dict, context: str) -> np.ndarray:
    entry = _ANSWER_CACHE.get(id(binary_dict))
    if entry is None or entry[0] is not binary_dict or entry[1] is not numeric_dict:
        if len(_ANSWER_CACHE) >= 8:
            # bound the registry itself: long-running servers may load
            # many question sets; drop all cached sets rather than pin
            # them (and their answer vectors) forever
            _ANSWER_CACHE.clear()
        entry = (binary_dict, numeric_dict, {})
        _ANSWER_CACHE[id(binary_dict)] = entry
    cache = entry[2]
    vec = cache.get(context)
    if vec is None:
        vec = np.concatenate(
            [
                _binary_answers(binary_dict, context),
                _numeric_answers(numeric_dict, context),
            ]
        )
        vec.flags.writeable = False
        if len(cache) >= _ANSWER_CACHE_MAX:
            cache.clear()
        cache[context] = vec
    return vec


def _binary_answers(binary_dict, context: str) -> np.ndarray:
    out = np.zeros(len(binary_dict), dtype=np.float32)
    for i in range(len(binary_dict)):
        _, regexes = binary_dict[i]
        for rx in regexes:
            if rx.search(context) is not None:
                out[i] = 1.0
                break
    return out


def _numeric_answers(numeric_dict, context: str) -> np.ndarray:
    out = np.full(len(numeric_dict), -1.0, dtype=np.float32)
    for i in range(len(numeric_dict)):
        _, regex = numeric_dict[i]
        m = regex.search(context)
        if m is not None:
            out[i] = numeric_feature_value(m.group(1))
    return out


# --------------------------------------------------------------------------
# Coarse-coded subphone position features (Merlin-compatible)
# --------------------------------------------------------------------------

_CC_NPOINTS = 600


def _compute_coarse_coding_curves() -> np.ndarray:
    """Three overlapping Gaussian bumps over normalized phone position.

    Merlin (and nnmnkwii, which inherits it verbatim) fills the curves
    with ``scipy.stats.norm(mu, 0.4).pdf`` values — the normalization
    constant 1/(0.4*sqrt(2*pi)) ~= 0.99736 is part of the feature scale
    that reference-trained checkpoints and their input scalers were fit
    on, so it is kept (peak is slightly below 1.0 by design).
    """
    curves = np.zeros((3, _CC_NPOINTS))
    x1 = np.linspace(-1.5, 1.5, _CC_NPOINTS)
    x2 = np.linspace(-1.0, 2.0, _CC_NPOINTS)
    x3 = np.linspace(-0.5, 2.5, _CC_NPOINTS)
    sigma = 0.4
    pdf_norm = 1.0 / (sigma * np.sqrt(2.0 * np.pi))
    for row, (x, mu) in enumerate(((x1, 0.0), (x2, 0.5), (x3, 1.0))):
        curves[row] = pdf_norm * np.exp(-((x - mu) ** 2) / (2.0 * sigma**2))
    return curves


_CC_CURVES = _compute_coarse_coding_curves()


@lru_cache(maxsize=4096)
def _coarse_coding_features(num_frames: int) -> np.ndarray:
    """(num_frames, 3) coarse-coded relative-position features.

    Cached per phone duration (durations repeat heavily across a song;
    this sits on the per-frame featurization hot path)."""
    if num_frames <= 0:  # zero-frame phones (e.g. clipped segments)
        return np.zeros((0, 3), dtype=np.float32)
    rel = ((200.0 / num_frames) * np.arange(num_frames)).astype(np.int64)
    out = np.stack(
        [
            _CC_CURVES[0, 300 + rel],
            _CC_CURVES[1, 200 + rel],
            _CC_CURVES[2, 100 + rel],
        ],
        axis=1,
    ).astype(np.float32)
    out.setflags(write=False)
    return out


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------


def linguistic_features(
    labels: HTSLabels,
    binary_dict,
    numeric_dict,
    add_frame_features: bool = False,
    subphone_features: Optional[str] = None,
    frame_shift: int = 50000,
) -> np.ndarray:
    """Extract linguistic features from HTS labels.

    Args:
        labels: HTS labels (full-context).
        binary_dict, numeric_dict: question sets from
            :func:`ensemble_svs_with_interactions_tpu_torch.io.hts.load_question_set`.
        add_frame_features: emit one row per frame instead of per phone.
        subphone_features: for phone-level alignment labels (the singing
            case): ``None``, ``"coarse_coding"`` (3 position features +
            phone frame count appended per frame) or ``"minimal_phoneme"``
            (fraction through the phone forward / backward + phone frame
            count).  For HMM state-level alignment labels (``...[k]``
            contexts) the Merlin state modes are supported too:
            ``"full"`` (9 dims), ``"state_only"``, ``"frame_only"``,
            ``"uniform_state"``, ``"minimal_frame"``, ``"coarse_coding"``.
        frame_shift: frame shift in 100 ns units.

    Returns:
        (N, D) float32 array, N = num phones, states or frames.
    """
    subphone_features = normalize_subphone_features(subphone_features)
    if labels.is_state_alignment():
        return _state_alignment_features(
            labels,
            binary_dict,
            numeric_dict,
            add_frame_features=add_frame_features,
            subphone_features=subphone_features,
            frame_shift=frame_shift,
        )
    dict_size = len(binary_dict) + len(numeric_dict)
    frame_size = get_frame_feature_size(subphone_features)
    if subphone_features not in (None, "coarse_coding", "minimal_phoneme"):
        raise NotImplementedError(
            "subphone feature type not supported for phone-level alignment "
            f"labels: {subphone_features}"
        )
    if subphone_features is not None and not add_frame_features:
        raise ValueError("subphone features require add_frame_features=True")

    dim = dict_size + frame_size
    rows = []
    for s, e, context in labels:
        phone_vec = _phone_answers(binary_dict, numeric_dict, context)
        if not add_frame_features:
            rows.append(phone_vec[None, :])
            continue
        nframes = int(e / frame_shift) - int(s / frame_shift)
        block = np.zeros((nframes, dim), dtype=np.float32)
        block[:, :dict_size] = phone_vec[None, :]
        if subphone_features == "coarse_coding":
            block[:, dict_size : dict_size + 3] = _coarse_coding_features(nframes)
            block[:, dict_size + 3] = float(nframes)
        elif subphone_features == "minimal_phoneme":
            frac = (np.arange(nframes) + 1) / max(nframes, 1)
            block[:, dict_size] = frac                  # forward fraction
            block[:, dict_size + 1] = frac[::-1]        # backward fraction
            block[:, dict_size + 2] = float(nframes)    # phone duration
        rows.append(block)
    return np.concatenate(rows, axis=0).astype(np.float32, copy=False)


def _state_alignment_features(
    labels: HTSLabels,
    binary_dict,
    numeric_dict,
    add_frame_features: bool = False,
    subphone_features: Optional[str] = None,
    frame_shift: int = 50000,
) -> np.ndarray:
    """Merlin featurizer for HMM state-level alignment labels.

    Each label line carries a ``[k]`` state suffix (states numbered
    2..S+1, HTK convention).  Feature semantics follow Merlin's
    ``load_labels_with_state_alignment`` (inherited by the reference via
    nnmnkwii; nnsvs never feeds state-aligned singing
    labels, but the mode surface is part of the frontend contract):

      * ``full`` (9): fraction through state fwd/bwd, state length,
        state index fwd/bwd, phone length, state/phone length ratio,
        fraction through phone bwd/fwd.
      * ``state_only`` (1): state index.
      * ``frame_only`` (1): fraction through phone (forward).
      * ``uniform_state`` (2): fraction through phone + state index a
        uniform 1..S split of the phone would assign to the frame.
      * ``minimal_frame`` (2): fraction through state (fwd) + state index.
      * ``coarse_coding`` (4): 3 coarse-coded phone positions + phone
        frame count.

    Without ``add_frame_features``: one row per phone (``None``) or one
    row per state (``state_only``).
    """
    dict_size = len(binary_dict) + len(numeric_dict)
    frame_size = get_frame_feature_size(subphone_features)
    if subphone_features == "minimal_phoneme":
        raise NotImplementedError(
            "minimal_phoneme is a phone-level alignment mode; state-level "
            "labels support full/state_only/frame_only/uniform_state/"
            "minimal_frame/coarse_coding"
        )
    if not add_frame_features and subphone_features not in (None, "state_only"):
        raise ValueError(
            "without add_frame_features, subphone_features must be None "
            "(one row per phone) or 'state_only' (one row per state)"
        )
    dim = dict_size + (frame_size if add_frame_features else 0)

    # ---- split into phones: state index sequence 2,3,...,S+1 per phone ----
    entries = []  # (frames, state_index_1based, context)
    for s, e, context in labels:
        state_1b = int(context[-2]) - 1  # HTK state 2..S+1 -> 1..S
        frames = int(e / frame_shift) - int(s / frame_shift)
        entries.append((frames, state_1b, context[:-3]))
    phones = []  # list of lists of (frames, state_index)
    for ent in entries:
        if ent[1] == 1 or not phones:
            phones.append([ent])
        else:
            phones[-1].append(ent)
    state_number = max(len(p) for p in phones)

    rows = []
    for phone in phones:
        context = phone[0][2]
        phone_vec = _phone_answers(binary_dict, numeric_dict, context)
        phone_duration = sum(f for f, _, _ in phone)
        if not add_frame_features:
            n = len(phone) if subphone_features == "state_only" else 1
            rows.append(np.tile(phone_vec[None, :], (n, 1)))
            continue
        if subphone_features == "coarse_coding":
            cc = _coarse_coding_features(phone_duration)
        state_duration_base = 0
        frame_in_phone = 0
        for frames, state_index, _ in phone:
            if frames <= 0:
                continue
            block = np.zeros((frames, dim), dtype=np.float32)
            block[:, :dict_size] = phone_vec[None, :]
            i = np.arange(frames, dtype=np.float32)
            d = dict_size
            if subphone_features == "full":
                block[:, d] = (i + 1) / frames
                block[:, d + 1] = (frames - i) / frames
                block[:, d + 2] = float(frames)
                block[:, d + 3] = float(state_index)
                block[:, d + 4] = float(state_number + 1 - state_index)
                block[:, d + 5] = float(phone_duration)
                block[:, d + 6] = float(frames) / phone_duration
                block[:, d + 7] = (phone_duration - i - state_duration_base) / phone_duration
                block[:, d + 8] = (state_duration_base + i + 1) / phone_duration
            elif subphone_features == "state_only":
                block[:, d] = float(state_index)
            elif subphone_features == "frame_only":
                block[:, d] = (frame_in_phone + i + 1) / phone_duration
            elif subphone_features == "uniform_state":
                cur = frame_in_phone + i + 1
                block[:, d] = cur / phone_duration
                avg = phone_duration / float(state_number)
                block[:, d + 1] = np.minimum(
                    np.floor((cur - 1) / avg) + 1, state_number
                )
            elif subphone_features == "minimal_frame":
                block[:, d] = (i + 1) / frames
                block[:, d + 1] = float(state_index)
            elif subphone_features == "coarse_coding":
                sl = slice(frame_in_phone, frame_in_phone + frames)
                block[:, d : d + 3] = cc[sl]
                block[:, d + 3] = float(phone_duration)
            elif subphone_features is not None:
                raise ValueError(
                    f"unknown subphone feature type: {subphone_features}"
                )
            rows.append(block)
            state_duration_base += frames
            frame_in_phone += frames
    return np.concatenate(rows, axis=0).astype(np.float32, copy=False)


def duration_features(labels: HTSLabels, frame_shift: int = 50000) -> np.ndarray:
    """Per-phone durations in frames, shape (N, 1) float32.

    For state-alignment labels: one row per phone with the per-state
    durations, shape (num_phones, num_states), Merlin-style.
    """
    if labels.is_state_alignment():
        rows, cur = [], []
        for s, e, context in labels:
            if int(context[-2]) - 1 == 1 and cur:
                rows.append(cur)
                cur = []
            cur.append(int(e / frame_shift) - int(s / frame_shift))
        if cur:
            rows.append(cur)
        n_states = max(len(r) for r in rows)
        out = np.zeros((len(rows), n_states), dtype=np.float32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out
    s = np.asarray(labels.start_times) // frame_shift
    e = np.asarray(labels.end_times) // frame_shift
    return (e - s).astype(np.float32).reshape(-1, 1)
