"""jaCappella-style multitrack corpus preparation (the recipe's stage -1):
the port's copy of ``ensemble_svs_with_interactions_tpu/bin/
data_prep_multitrack.py``.  Host code; it writes labels, wavs and lists.

Input corpus layout (one directory per singer):

    <root>/<spk>/<song>_aligned.lab   # mono phone alignment (100 ns units)
    <root>/<spk>/<song>_score.lab     # full-context score labels
    <root>/<spk>/<song>.wav           # solo recording of that singer

Output layout (consumed by the recipe's stages 1+):

    <out>/timelag/label_phone_align/<spk>_<song>_segN.lab   (note onsets)
    <out>/timelag/label_phone_score/<spk>_<song>_segN.lab
    <out>/duration/label_phone_align/<spk>_<song>_segN.lab
    <out>/acoustic/wav/<spk>_<song>_segN.wav
    <out>/acoustic/label_phone_align/<spk>_<song>_segN.lab
    <out>/acoustic/label_phone_score/<spk>_<song>_segN.lab
    <out>/lists/{utt_list.txt,train_no_dev.list,dev.list,eval.list}

Semantics:
  * Segmentation is synchronized across all singers of a song: the song is
    cut where EVERY singer is silent for >= ``silence_threshold`` seconds
    (plus a forced cut after ``force_split_threshold`` seconds), so the
    same segment index covers the same musical time for every part.
  * Per-segment timelag data applies a constant offset correction between
    score and alignment (estimated over note onsets) and drops notes whose
    residual lag falls outside the allowed ranges; segments where fewer
    than half the notes survive are blacklisted for all phases.
  * Splits are SONG-level: all singers/segments of a song land in the same
    train/dev/eval list.

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.\
data_prep_multitrack corpus_root out_dir --spk-list a,b [options]
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.utils.logger import getLogger

logger = getLogger(verbose=1, name="data_prep")

HTS_FRAME_SHIFT = 50000  # 5 ms in 100 ns units


def _is_silence(context: str) -> bool:
    return hts.is_silence_context(context)


def _nosil_duration(labels: hts.HTSLabels, long_sil_threshold: float = 5.0) -> float:
    """Total duration in seconds, not counting silences longer than the
    threshold (reference compute_nosil_duration)."""
    total = 0.0
    for s, e, c in labels:
        d = (e - s) * 1e-7
        if _is_silence(c) and d > long_sil_threshold:
            continue
        total += d
    return total


def _fix_offset(labels: hts.HTSLabels) -> hts.HTSLabels:
    off = labels.start_times[0]
    labels.start_times = [s - off for s in labels.start_times]
    labels.end_times = [e - off for e in labels.end_times]
    return labels


def _trim_sil(labels: hts.HTSLabels) -> hts.HTSLabels:
    """Strip leading/trailing sil/pau entries."""
    lo, hi = 0, len(labels) - 1
    while lo < hi and _is_silence(labels.contexts[lo]):
        lo += 1
    while hi > lo and _is_silence(labels.contexts[hi]):
        hi -= 1
    return labels[lo : hi + 1]


def _remove_sil(labels: hts.HTSLabels) -> hts.HTSLabels:
    keep = [i for i, c in enumerate(labels.contexts) if not _is_silence(c)]
    return labels[keep]


def multitrack_cut_positions(
    aligned_labels,
    silence_threshold: float = 1.0,
    force_split_threshold: float = 8.0,
):
    """Times (100 ns) at which to cut ALL tracks of a song.

    Sweep-line over the union of the singers' non-silence intervals: a cut
    is allowed when no singer is voicing, has lasted >= silence_threshold
    since the previous cut, and a cut is forced once a segment exceeds
    force_split_threshold seconds (reference segment_multitrack_labels).
    """
    events = []
    for lab in aligned_labels:
        for s, e, c in lab:
            if _is_silence(c):
                events.append((int(s), -1))  # a singer goes quiet
                events.append((int(e), +1))  # and resumes
    events.sort()

    active = len(aligned_labels)
    cuts = [max(int(lab.start_times[0]) for lab in aligned_labels)]
    sil_t = int(silence_threshold * 1e7)
    force_t = int(force_split_threshold * 1e7)
    for i, (t, delta) in enumerate(events):
        active += delta
        if i + 1 < len(events) and events[i + 1][0] == t:
            continue
        if active == 0 and t > 0 and t - cuts[-1] >= sil_t:
            cuts.append(t)
        elif t - cuts[-1] >= force_t:
            cuts.append(t)
    # end at the shortest track so every part has audio for every segment;
    # drop any (forced) cut at/past that end first so the final boundary is
    # exactly `end` and the list stays strictly monotonic
    end = min(int(lab.end_times[-1]) for lab in aligned_labels)
    cuts = [c for c in cuts if c < end]
    cuts.append(end)
    cuts = [c for i, c in enumerate(cuts) if i == 0 or c > cuts[i - 1]]
    return cuts


def segment_by_positions(labels: hts.HTSLabels, cuts):
    """Split labels at the given time positions; entries straddling a cut
    are clipped to it.  Returns (segments, (start_idx, end_idx) pairs)."""
    segments, indices = [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        seg = hts.HTSLabels(frame_shift=labels.frame_shift)
        i0, i1 = None, None
        for idx, (s, e, c) in enumerate(labels):
            if s < hi and lo < e:
                seg.append((max(s, lo), min(e, hi), c), strict=False)
                if i0 is None:
                    i0 = idx
                i1 = idx
        segments.append(seg)
        indices.append((i0, i1))
    return segments, indices


def _round_to_frames(labels: hts.HTSLabels) -> hts.HTSLabels:
    out = hts.HTSLabels(frame_shift=HTS_FRAME_SHIFT)
    for s, e, c in labels:
        b = round(int(s) / HTS_FRAME_SHIFT) * HTS_FRAME_SHIFT
        t = round(int(e) / HTS_FRAME_SHIFT) * HTS_FRAME_SHIFT
        if t <= b:  # keep a minimum one-frame phone
            t = b + HTS_FRAME_SHIFT
        if out.end_times and b < out.end_times[-1]:
            b = out.end_times[-1]
            t = max(t, b + HTS_FRAME_SHIFT)
        out.append((b, t, c), strict=False)
    return out


def _load_song_pairs(root: Path, spk: str):
    """[(song, aligned mono lab path, score lab path)] for one singer."""
    pairs = []
    for align_path in sorted((root / spk).glob("*_aligned.lab")):
        m = re.match(r"(.*)_aligned$", align_path.stem)
        song = m.group(1)
        score_path = root / spk / f"{song}_score.lab"
        if score_path.exists():
            pairs.append((song, align_path, score_path))
    return pairs


def prepare_corpus(
    root,
    out_dir,
    spk_list,
    silence_threshold: float = 1.0,
    force_split_threshold: float = 8.0,
    timelag_allowed_range=(-20, 19),
    timelag_allowed_range_rest=(-40, 39),
    offset_correction_threshold: float = 0.01,
    global_offset_correction: bool = False,
    sample_rate: int = 0,  # resample wavs to this rate; 0 keeps source
    dev_songs=None,
    eval_songs=None,
):
    """Full corpus preparation.  Returns the list of utterance ids."""
    from scipy.io import wavfile

    root, out = Path(root), Path(out_dir)
    for sub in (
        "timelag/label_phone_align",
        "timelag/label_phone_score",
        "duration/label_phone_align",
        "acoustic/wav",
        "acoustic/label_phone_align",
        "acoustic/label_phone_score",
        "lists",
    ):
        (out / sub).mkdir(parents=True, exist_ok=True)

    # ---- collect aligned-full + rounded-score labels per (song, spk) ------
    songs = {}
    for spk in spk_list:
        for song, align_path, score_path in _load_song_pairs(root, spk):
            mono = hts.load(align_path)
            score = hts.load(score_path)
            if len(mono) != len(score):
                logger.warning(
                    "%s/%s: alignment/score length mismatch (%d vs %d), skipped",
                    spk, song, len(mono), len(score),
                )
                continue
            # aligned full-context labels: alignment times + score contexts
            aligned = hts.HTSLabels(
                list(mono.start_times), list(mono.end_times),
                list(score.contexts), HTS_FRAME_SHIFT,
            )
            aligned = _round_to_frames(aligned)
            score = _round_to_frames(score)
            # song-level offset between alignment and score, over
            # sil-removed note onsets (reference data_prep_multitrack.py:
            # 476-497): the correction gate for every segment of the song
            a_ns = _remove_sil(aligned.copy())
            s_ns = _remove_sil(score.copy())
            g_ni = hts.get_note_indices(s_ns)
            if len(g_ni):
                g_off = int(
                    round(
                        float(
                            np.mean(
                                np.asarray(a_ns[g_ni].start_times)
                                - np.asarray(s_ns[g_ni].start_times)
                            )
                        )
                        / HTS_FRAME_SHIFT
                    )
                    * HTS_FRAME_SHIFT
                )
            else:
                g_off = 0
            apply_corr = abs(g_off * 1e-7) > offset_correction_threshold
            songs.setdefault(song, {})[spk] = (aligned, score, g_off, apply_corr)

    utt_ids, blacklist = [], set()
    song_of_utt = {}
    for song in sorted(songs):
        tracks = songs[song]
        aligned_all = [tracks[s][0] for s in sorted(tracks)]
        cuts = multitrack_cut_positions(
            aligned_all, silence_threshold, force_split_threshold
        )
        if len(cuts) < 2:
            logger.warning("%s: no valid cut positions, skipped", song)
            continue
        for spk in sorted(tracks):
            aligned, score, g_off, apply_corr = tracks[spk]
            segs, idx = segment_by_positions(aligned, cuts)
            # (None, None) marks a cut interval overlapping no label entry;
            # emit an empty slice so the per-segment blacklist guard below
            # handles it instead of crashing the whole prep run
            score_segs = [
                score[i0 : i1 + 1] if i0 is not None else score[0:0]
                for (i0, i1) in idx
            ]
            wav_path = root / spk / f"{song}.wav"
            wav, sr = (None, None)
            if not wav_path.exists():
                raise FileNotFoundError(
                    f"{wav_path}: every (singer, song) needs a wav; a "
                    "label-only track would put utts in the train lists "
                    "that the acoustic phase cannot use"
                )
            if wav_path.exists():
                sr, wav = wavfile.read(wav_path)
                # normalize ANY PCM dtype to [-1, 1] floats (librosa.load
                # semantics in the reference); jaCappella ships 24-bit PCM,
                # which scipy reads as int32
                if wav.dtype == np.uint8:  # WAV uint8 is offset-binary
                    wav = (wav.astype(np.float32) - 128.0) / 128.0
                elif np.issubdtype(wav.dtype, np.integer):
                    wav = wav.astype(np.float32) / float(
                        -np.iinfo(wav.dtype).min
                    )
                else:
                    wav = wav.astype(np.float32)
                if sample_rate and sr != sample_rate:
                    from scipy.signal import resample_poly

                    g = np.gcd(int(sample_rate), int(sr))
                    wav = resample_poly(
                        wav, sample_rate // g, sr // g, axis=0
                    ).astype(np.float32)
                    sr = int(sample_rate)

            for seg_idx, (a_seg, s_seg) in enumerate(zip(segs, score_segs)):
                utt = f"{spk}_{song}_seg{seg_idx}"
                if len(a_seg) == 0 or _nosil_duration(a_seg, 0) < 1e-9:
                    blacklist.add(utt)
                    continue

                # ---- timelag: valid note onsets with offset correction ---
                a_trim = _trim_sil(a_seg.copy())
                s_trim = _trim_sil(s_seg.copy())
                if len(a_trim) < 2 or len(s_trim) != len(a_trim):
                    blacklist.add(utt)
                    continue
                note_indices = hts.get_note_indices(s_trim)
                onset_a = np.asarray(a_trim[note_indices].start_times)
                onset_s = np.asarray(s_trim[note_indices].start_times)
                seg_off = int(
                    round(float(np.mean(onset_a - onset_s)) / HTS_FRAME_SHIFT)
                    * HTS_FRAME_SHIFT
                )
                # the song-level offset gates the correction; the applied
                # value is the song offset (global mode) or this segment's
                # (reference data_prep_multitrack.py:537-543)
                if apply_corr:
                    offset = g_off if global_offset_correction else seg_off
                else:
                    offset = 0
                s_shift = s_trim.copy()
                s_shift.start_times = [t + offset for t in s_shift.start_times]
                s_shift.end_times = [t + offset for t in s_shift.end_times]
                onset_s = onset_s + offset

                valid = []
                for k, ni in enumerate(note_indices):
                    # absolute lag, as in the reference's validity check
                    # (data_prep_multitrack.py:553 lag = np.abs(a - b)/50000)
                    lag = abs(onset_a[k] - onset_s[k]) / HTS_FRAME_SHIFT
                    rng = (
                        timelag_allowed_range_rest
                        if _is_silence(s_shift.contexts[ni])
                        else timelag_allowed_range
                    )
                    if rng[0] <= lag <= rng[1]:
                        valid.append(ni)
                if len(valid) < 2 or len(valid) < len(note_indices) / 2:
                    logger.info(
                        "%s: %d/%d valid time-lags -> blacklisted",
                        utt, len(valid), len(note_indices),
                    )
                    blacklist.add(utt)
                    continue

                a_trim[valid].save(out / "timelag/label_phone_align" / f"{utt}.lab")
                s_shift[valid].save(out / "timelag/label_phone_score" / f"{utt}.lab")

                # ---- duration: offset-zeroed aligned segment -------------
                _fix_offset(a_seg.copy()).save(
                    out / "duration/label_phone_align" / f"{utt}.lab"
                )

                # ---- acoustic: wav slice + offset-zeroed labels ----------
                if wav is not None:
                    b = int(a_seg.start_times[0] * 1e-7 * sr)
                    e = int(a_seg.end_times[-1] * 1e-7 * sr)
                    seg_wav = wav[b:e]
                    wavfile.write(
                        out / "acoustic/wav" / f"{utt}.wav",
                        sr,
                        (np.clip(seg_wav, -1, 1) * 32767).astype(np.int16),
                    )
                _fix_offset(a_seg.copy()).save(
                    out / "acoustic/label_phone_align" / f"{utt}.lab"
                )
                _fix_offset(s_seg.copy()).save(
                    out / "acoustic/label_phone_score" / f"{utt}.lab"
                )
                utt_ids.append(utt)
                song_of_utt[utt] = song

    # ---- song-level splits (reference split_by_song_multitrack.py) -------
    all_songs = sorted({song_of_utt[u] for u in utt_ids})
    dev_songs = list(dev_songs or [])
    eval_songs = list(eval_songs or [])
    if not dev_songs and not eval_songs and len(all_songs) >= 3:
        eval_songs, dev_songs = [all_songs[-1]], [all_songs[-2]]
    lists = {
        "train_no_dev": [
            u for u in utt_ids
            if song_of_utt[u] not in dev_songs + eval_songs
        ],
        "dev": [u for u in utt_ids if song_of_utt[u] in dev_songs],
        "eval": [u for u in utt_ids if song_of_utt[u] in eval_songs],
    }
    (out / "lists" / "utt_list.txt").write_text("\n".join(utt_ids) + "\n")
    for name, items in lists.items():
        (out / "lists" / f"{name}.list").write_text(
            "\n".join(items) + ("\n" if items else "")
        )
    logger.info(
        "prepared %d utterances (%d blacklisted): %d train / %d dev / %d eval",
        len(utt_ids), len(blacklist),
        len(lists["train_no_dev"]), len(lists["dev"]), len(lists["eval"]),
    )
    return utt_ids


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("corpus_root", help="corpus root (one dir per singer)")
    ap.add_argument("out_dir", help="output data directory")
    ap.add_argument("--spk-list", required=True,
                    help="comma-separated singer directory names")
    ap.add_argument("--silence-threshold", type=float, default=1.0)
    ap.add_argument("--force-split-threshold", type=float, default=8.0)
    ap.add_argument("--offset-correction-threshold", type=float, default=0.01)
    ap.add_argument("--global-offset-correction", action="store_true",
                    help="apply the song-level offset to every segment "
                    "instead of per-segment offsets")
    ap.add_argument("--sample-rate", type=int, default=0,
                    help="resample wavs to this rate (0 = keep source rate)")
    ap.add_argument("--dev-songs", default="",
                    help="comma-separated song names for the dev split")
    ap.add_argument("--eval-songs", default="",
                    help="comma-separated song names for the eval split")
    args = ap.parse_args(argv)
    prepare_corpus(
        args.corpus_root,
        args.out_dir,
        [s for s in args.spk_list.split(",") if s],
        silence_threshold=args.silence_threshold,
        force_split_threshold=args.force_split_threshold,
        offset_correction_threshold=args.offset_correction_threshold,
        global_offset_correction=args.global_offset_correction,
        sample_rate=args.sample_rate,
        dev_songs=[s for s in args.dev_songs.split(",") if s],
        eval_songs=[s for s in args.eval_songs.split(",") if s],
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
