"""Multi-track datasets, as ``ensemble_svs_with_interactions_tpu/data/
multitrack.py`` defines them: every pair (i <= j, self-pairs included) of
same-segment files across singers, the two-pointer note merge of two
tracks (timelag and duration models) and frame-synced pairs (acoustic
models), batched by length.  NumPy on the host, with the JAX package's
random draws in the same order, so the same dumps and seed give bitwise the
same batches.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.data.dataset import (
    batch_by_size,
    pad_batch,
)

_SEG_RE = re.compile(r"_(.*?)-")
_SPK_RE = re.compile(r"^([A-Za-z0-9]+)_")


def segment_name(path) -> Optional[str]:
    m = _SEG_RE.search(Path(path).name)
    return m.group(1) if m else None


def speaker_name(path) -> Optional[str]:
    m = _SPK_RE.match(Path(path).name)
    return m.group(1) if m else None


def pair_multitrack_files(
    in_dir, out_dir, max_frames: Optional[int] = None
) -> List[Tuple[Tuple[Path, Path], Tuple[Path, Path]]]:
    """All ordered pairs ((in0, out0), (in1, out1)) of same-segment files.

    Files are named ``spk_segment-feats.npy``; every (i, j) with i <= j
    and matching segment id forms a pair (self-pairs included).
    """
    in_files = sorted(Path(in_dir).glob("*-feats.npy"))
    out_files = {p.name: p for p in sorted(Path(out_dir).glob("*-feats.npy"))}
    files = [(p, out_files[p.name]) for p in in_files if p.name in out_files]
    if max_frames is not None:
        files = [
            (a, b)
            for a, b in files
            if np.load(a, mmap_mode="r").shape[0] <= max_frames
        ]
    segs = [segment_name(a) for a, _ in files]
    pairs = []
    for i in range(len(files)):
        for j in range(i, len(files)):
            if segs[i] is not None and segs[i] == segs[j]:
                pairs.append((files[i], files[j]))
    return pairs


class MultiTrackFeatsDataset:
    """Pairs of tracks; items are (x0, y0, spk0, x1, y1, spk1)."""

    def __init__(
        self,
        in_dir,
        out_dir,
        spk_names: Sequence[str],
        max_frames: Optional[int] = None,
        load_times: bool = False,
    ):
        self.pairs = pair_multitrack_files(in_dir, out_dir, max_frames)
        self.spk_names = list(spk_names)
        self.load_times = load_times
        self._lengths: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.pairs)

    def _spk_id(self, path) -> int:
        # prefix match against the declared names first (they may contain
        # underscores or characters the generic regex rejects)
        stem = Path(path).name
        for s in sorted(self.spk_names, key=len, reverse=True):
            if stem.startswith(s + "_"):
                return self.spk_names.index(s)
        name = speaker_name(path)
        if name in self.spk_names:
            return self.spk_names.index(name)
        raise ValueError(
            f"cannot map '{stem}' to a speaker: prefix not in spk_names "
            f"{self.spk_names} (check the dataset spk_names config)"
        )

    def __getitem__(self, idx):
        (in0, out0), (in1, out1) = self.pairs[idx]
        item = {
            "x0": np.load(in0),
            "y0": np.load(out0),
            "spk0": self._spk_id(in0),
            "x1": np.load(in1),
            "y1": np.load(out1),
            "spk1": self._spk_id(in1),
        }
        if self.load_times:
            for k, path in (("times0", in0), ("times1", in1)):
                item[k] = np.load(str(path).replace("-feats.npy",
                                                    "-times.npy"))
        return item

    def lengths(self) -> np.ndarray:
        """Per-pair max track length (frame-synced padding size)."""
        if self._lengths is None:
            cache: Dict[Path, int] = {}

            def _len(p) -> int:
                if p not in cache:
                    cache[p] = int(np.load(p, mmap_mode="r").shape[0])
                return cache[p]

            self._lengths = np.array(
                [max(_len(a), _len(c)) for (a, _), (c, _) in self.pairs]
            )
        return self._lengths

    def merged_lengths(self) -> np.ndarray:
        """Per-pair length AFTER the two-pointer note merge.

        The merge emits one row per distinct event time, so the merged
        length is ``len0 + len1 - |times0 ∩ times1|`` — up to ~2x the
        per-track max that ``lengths()`` reports.  Note-synced batch
        sizing must use this, or realized padded batches blow past the
        ``max_tokens`` bound.  Falls back to the ``len0 + len1`` upper
        bound when a ``-times.npy`` dump is missing.
        """
        cache: Dict[Path, Optional[np.ndarray]] = {}

        def _times(feat_path) -> Optional[np.ndarray]:
            p = Path(str(feat_path).replace("-feats.npy", "-times.npy"))
            if p not in cache:
                cache[p] = np.load(p) if p.exists() else None
            return cache[p]

        out = []
        for (a, _), (c, _) in self.pairs:
            ta, tc = _times(a), _times(c)
            if ta is None or tc is None:
                la = int(np.load(a, mmap_mode="r").shape[0])
                lc = int(np.load(c, mmap_mode="r").shape[0])
                out.append(la + lc)
            else:
                out.append(len(ta) + len(tc) - len(np.intersect1d(ta, tc)))
        return np.array(out)


def merge_tracks_by_notes(x0, y0, times0, x1, y1, times1):
    """Two-pointer merge of two note/phone sequences into one timeline.

    Where a track has no event at a merged position, zero rows are inserted
    and its presence mask is False.  Returns (mx0, my0, mask0, mx1, my1,
    mask1), all of the merged length.
    """
    a = np.append(times0, times0[-1] + times1[-1])
    b = np.append(times1, times0[-1] + times1[-1])
    rows0, rows1, ry0, ry1, m0, m1 = [], [], [], [], [], []
    aid = bid = 0
    while aid < len(a) - 1 or bid < len(b) - 1:
        if a[aid] < b[bid]:
            rows0.append(x0[aid])
            rows1.append(np.zeros_like(x0[aid]))
            ry0.append(y0[aid])
            ry1.append(np.zeros_like(y0[aid]))
            m0.append(True)
            m1.append(False)
            aid += 1
        elif a[aid] > b[bid]:
            rows0.append(np.zeros_like(x1[bid]))
            rows1.append(x1[bid])
            ry0.append(np.zeros_like(y1[bid]))
            ry1.append(y1[bid])
            m0.append(False)
            m1.append(True)
            bid += 1
        else:
            rows0.append(x0[aid])
            rows1.append(x1[bid])
            ry0.append(y0[aid])
            ry1.append(y1[bid])
            m0.append(True)
            m1.append(True)
            aid += 1
            bid += 1
    return (np.asarray(rows0, np.float32), np.asarray(ry0, np.float32),
            np.asarray(m0, bool), np.asarray(rows1, np.float32),
            np.asarray(ry1, np.float32), np.asarray(m1, bool))


class MultiTrackBatchIterator:
    """Length-bucketed, padded multitrack batches.

    ``sync="notes"`` runs the two-pointer note merge per item (timelag /
    duration models); ``sync="frames"`` assumes frame-aligned tracks
    (acoustic models) and just pads both to a common length.

    Yields dict(in_feats0, out_feats0, mask0, in_feats1, out_feats1,
    mask1, spks0, spks1, lengths).
    """

    def __init__(
        self,
        dataset: MultiTrackFeatsDataset,
        sync: str = "frames",
        max_tokens: int = 32000,
        time_multiple: int = 32,
        batch_multiple: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        length_cap: Optional[int] = None,
    ):
        assert sync in ("notes", "frames")
        # random crops only make sense for frame-synced (acoustic) batches
        assert length_cap is None or sync == "frames"
        self.dataset = dataset
        self.sync = sync
        self.time_multiple = time_multiple
        self.batch_multiple = batch_multiple
        self.shuffle = shuffle
        self.length_cap = length_cap
        self.rng = np.random.default_rng(seed)
        # note sync sizes batches by the POST-merge length (up to ~2x the
        # per-track max when onsets are disjoint), so max_tokens bounds the
        # realized padded batch, not the pre-merge one
        sizing = (dataset.merged_lengths() if sync == "notes"
                  else dataset.lengths())
        if length_cap is not None:
            # with random crops the REALIZED item length is capped, so the
            # token budget packs many more (short) items per batch: 64
            # crops of 256 frames under 16384 tokens
            sizing = np.minimum(np.asarray(sizing), length_cap)
        self.batches = batch_by_size(
            sizing,
            max_tokens=max_tokens,
            required_batch_size_multiple=batch_multiple,
        )

    def __len__(self):
        return len(self.batches)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.batches))
        if self.shuffle:
            self.rng.shuffle(order)
        for bi in order:
            items = [self.dataset[i] for i in self.batches[bi]]
            xs0, ys0, ms0, xs1, ys1, ms1, spk0, spk1 = ([] for _ in range(8))
            for it in items:
                if self.sync == "notes":
                    mx0, my0, m0, mx1, my1, m1 = merge_tracks_by_notes(
                        it["x0"], it["y0"], it["times0"],
                        it["x1"], it["y1"], it["times1"],
                    )
                else:
                    n = max(len(it["x0"]), len(it["x1"]))

                    def _padto(v, n=n):
                        return np.pad(v, ((0, n - len(v)), (0, 0)))

                    mx0, my0 = _padto(it["x0"]), _padto(it["y0"])
                    mx1, my1 = _padto(it["x1"]), _padto(it["y1"])
                    m0 = np.arange(n) < len(it["x0"])
                    m1 = np.arange(n) < len(it["x1"])
                    if self.length_cap is not None and n > self.length_cap:
                        # ONE window across both tracks keeps the pairwise
                        # interaction losses frame-aligned
                        start = int(self.rng.integers(n - self.length_cap + 1))
                        sl = slice(start, start + self.length_cap)
                        mx0, my0, mx1, my1 = mx0[sl], my0[sl], mx1[sl], my1[sl]
                        m0, m1 = m0[sl], m1[sl]
                xs0.append(mx0)
                ys0.append(my0)
                ms0.append(m0)
                xs1.append(mx1)
                ys1.append(my1)
                ms1.append(m1)
                spk0.append(it["spk0"])
                spk1.append(it["spk1"])

            tm, bm = self.time_multiple, self.batch_multiple
            in0, lengths = pad_batch(xs0, tm, bm)
            out0, _ = pad_batch(ys0, tm, bm)
            in1, _ = pad_batch(xs1, tm, bm)
            out1, _ = pad_batch(ys1, tm, bm)
            B_pad, T_pad = in0.shape[0], in0.shape[1]
            mask0 = np.zeros((B_pad, T_pad), bool)
            mask1 = np.zeros((B_pad, T_pad), bool)
            for i, (m0, m1) in enumerate(zip(ms0, ms1)):
                mask0[i, : len(m0)] = m0
                mask1[i, : len(m1)] = m1
            spks0 = np.zeros(B_pad, np.int32)
            spks1 = np.zeros(B_pad, np.int32)
            spks0[: len(spk0)] = spk0
            spks1[: len(spk1)] = spk1
            yield {
                "in_feats0": in0,
                "out_feats0": out0,
                "mask0": mask0,
                "in_feats1": in1,
                "out_feats1": out1,
                "mask1": mask1,
                "spks0": spks0,
                "spks1": spks1,
                "lengths": lengths,
            }
