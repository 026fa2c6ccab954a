"""Datasets and batching for the trainers, as
``ensemble_svs_with_interactions_tpu/data/dataset.py`` defines them:
length-bucketed batches bounded by total padded frames, the time axis
padded to a multiple of ``time_multiple`` and the batch axis to a multiple
of ``batch_multiple``, masks instead of packed sequences, padded entries of
length 0.  NumPy on the host, with the same ``np.random.default_rng(seed)``
draws in the same order, so the same dumps and seed give bitwise the same
batches as the JAX package's iterators.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def load_utt_list(path) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def _npy_files(directory) -> List[Path]:
    return sorted(Path(directory).glob("*-feats.npy"))


class FeatsDataset:
    """Pairs of input/output ``*-feats.npy`` dumps.

    Args:
        in_dir / out_dir: directories of per-utterance feature dumps.
        utt_ids: restrict to these utterance ids (prefix match on filename).
        max_frames: drop segments longer than this many frames.
    """

    def __init__(self, in_dir, out_dir, utt_ids=None,
                 max_frames: Optional[int] = None):
        in_files = {p.name: p for p in _npy_files(in_dir)}
        out_files = {p.name: p for p in _npy_files(out_dir)}
        names = sorted(set(in_files) & set(out_files))
        if utt_ids is not None:
            keep = set(utt_ids)
            names = [n for n in names if n.replace("-feats.npy", "") in keep]
        self.pairs = [(in_files[n], out_files[n]) for n in names]
        self._length_cache: Optional[np.ndarray] = None
        if max_frames is not None:
            kept, kept_len = [], []
            for a, b in self.pairs:
                n = np.load(a, mmap_mode="r").shape[0]
                if n <= max_frames:
                    kept.append((a, b))
                    kept_len.append(n)
            self.pairs = kept
            # the filter already read every file header; keep the lengths
            self._length_cache = np.array(kept_len, dtype=np.int64)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        a, b = self.pairs[idx]
        return np.load(a), np.load(b)

    def utt_id(self, idx) -> str:
        return self.pairs[idx][0].name.replace("-feats.npy", "")

    def lengths(self) -> np.ndarray:
        if self._length_cache is None:
            self._length_cache = np.array(
                [np.load(a, mmap_mode="r").shape[0] for a, _ in self.pairs]
            )
        return self._length_cache


_SPK_RE = re.compile(r"^([A-Za-z0-9]+)_")


class MultiSpeakerFeatsDataset(FeatsDataset):
    """Speaker id parsed from the filename prefix (``spk_utt-feats.npy``)."""

    def __init__(self, in_dir, out_dir, spk_names: Sequence[str], **kw):
        super().__init__(in_dir, out_dir, **kw)
        self.spk_names = list(spk_names)

    def spk_id(self, idx) -> int:
        name = self.utt_id(idx)
        # longest-prefix match against the declared names (they may
        # contain underscores/hyphens the generic regex rejects)
        for s in sorted(self.spk_names, key=len, reverse=True):
            if name.startswith(s + "_"):
                return self.spk_names.index(s)
        m = _SPK_RE.match(name)
        prefix = m.group(1) if m else name
        if prefix in self.spk_names:
            return self.spk_names.index(prefix)
        raise ValueError(
            f"cannot map '{name}' to a speaker: prefix not in spk_names "
            f"{self.spk_names} (check data.spk_names)"
        )

    def __getitem__(self, idx):
        x, y = super().__getitem__(idx)
        return x, y, self.spk_id(idx)


def batch_by_size(
    lengths: np.ndarray,
    indices: Optional[np.ndarray] = None,
    max_tokens: Optional[int] = 32000,
    max_sentences: Optional[int] = None,
    required_batch_size_multiple: int = 1,
) -> List[List[int]]:
    """Group sorted indices into batches bounded by total padded frames."""
    if indices is None:
        indices = np.argsort(lengths, kind="stable")
    batches: List[List[int]] = []
    cur: List[int] = []
    cur_max = 0
    for idx in indices:
        L = int(lengths[idx])
        # close (possibly repeatedly: the multiple-trim carries a remainder
        # that must also fit) until idx fits in the running batch
        while cur and (
            (max_tokens is not None
             and max(cur_max, L) * (len(cur) + 1) > max_tokens)
            or (max_sentences is not None and len(cur) >= max_sentences)
        ):
            # trim to a multiple for even device sharding
            m = required_batch_size_multiple
            keep = (max(len(cur) - len(cur) % m, m) if len(cur) >= m
                    else len(cur))
            batches.append(cur[:keep])
            cur = cur[keep:]
            cur_max = max((int(lengths[i]) for i in cur), default=0)
        cur.append(int(idx))
        cur_max = max(cur_max, L)
    if cur:
        batches.append(cur)
    return batches


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_batch(
    arrays: Sequence[np.ndarray],
    time_multiple: int = 32,
    batch_multiple: int = 1,
    pad_value: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length (T_i, D) arrays into (B', T', D) + lengths.

    T' and B' are rounded up to the given multiples; padded rows/entries are
    zero with length 0.
    """
    B = len(arrays)
    T = max(a.shape[0] for a in arrays)
    T_pad = _round_up(T, time_multiple)
    B_pad = _round_up(B, batch_multiple)
    D = arrays[0].shape[1]
    out = np.full((B_pad, T_pad, D), pad_value, dtype=np.float32)
    lengths = np.zeros(B_pad, dtype=np.int32)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
        lengths[i] = a.shape[0]
    return out, lengths


def prefetch_batches(iterable, depth: int = 2):
    """Yield from ``iterable`` while a background thread builds up to
    ``depth`` items ahead.

    Batch construction (npy loading, padding, host-side transforms,
    pinning) otherwise serializes with the steps on the one host thread.
    Producer exceptions re-raise at the consumer; closing the generator
    stops the producer.
    """
    import queue as _queue
    import threading

    q: "_queue.Queue" = _queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    sentinel = object()
    error: List[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def _produce():
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            error.append(e)
        finally:
            _put(sentinel)

    thread = threading.Thread(
        target=_produce, daemon=True, name="batch-prefetch"
    )
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()


class BucketedBatchIterator:
    """Iterate length-bucketed, padded batches over a FeatsDataset.

    Yields dict(in_feats, out_feats, lengths[, spks]) of numpy arrays.
    """

    def __init__(
        self,
        dataset: FeatsDataset,
        max_tokens: int = 32000,
        max_sentences: Optional[int] = None,
        time_multiple: int = 32,
        batch_multiple: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        length_cap: Optional[int] = None,
    ):
        self.dataset = dataset
        self.time_multiple = time_multiple
        self.batch_multiple = batch_multiple
        self.shuffle = shuffle
        self.length_cap = length_cap
        self.rng = np.random.default_rng(seed)
        lengths = dataset.lengths()
        if length_cap is not None:
            # random crops cap the realized item length, so the token
            # budget packs many more items per batch
            lengths = np.minimum(np.asarray(lengths), length_cap)
        self.batches = batch_by_size(
            lengths,
            max_tokens=max_tokens,
            max_sentences=max_sentences,
            required_batch_size_multiple=batch_multiple,
        )

    def __len__(self):
        return len(self.batches)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.batches))
        if self.shuffle:
            self.rng.shuffle(order)
        for bi in order:
            idxs = self.batches[bi]
            items = [self.dataset[i] for i in idxs]
            xs = [it[0] for it in items]
            ys = [it[1] for it in items]
            xs = [x[: min(len(x), len(y))] for x, y in zip(xs, ys)]
            ys = [y[: min(len(x), len(y))] for x, y in zip(xs, ys)]
            if self.length_cap is not None:
                cap = self.length_cap
                for i, (x, y) in enumerate(zip(xs, ys)):
                    if len(x) > cap:
                        start = int(self.rng.integers(len(x) - cap + 1))
                        xs[i] = x[start : start + cap]
                        ys[i] = y[start : start + cap]
            in_feats, lengths = pad_batch(
                xs, self.time_multiple, self.batch_multiple
            )
            out_feats, _ = pad_batch(ys, self.time_multiple,
                                     self.batch_multiple)
            batch = {
                "in_feats": in_feats,
                "out_feats": out_feats,
                "lengths": lengths,
            }
            if len(items[0]) > 2:
                spks = np.zeros(in_feats.shape[0], dtype=np.int32)
                for i, it in enumerate(items):
                    spks[i] = it[2]
                batch["spks"] = spks
            yield batch
