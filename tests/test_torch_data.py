"""The port's datasets and batch iterators against the JAX package's.

Both sides read the same seeded dumps (``chip_smoke.write_corpus``: a
3-singer corpus whose singers share some note onsets and differ at
others, frame-level acoustic dumps and note-level timing dumps with
``-times.npy``) and draw with the same seeds, and every array of every
batch must be bitwise equal: the JAX package's ``np.random.default_rng``
draws in the same order (shuffle first, then the crop offsets, item by
item).
"""

import threading

import numpy as np
import pytest

import chip_smoke
from ensemble_svs_with_interactions_tpu.data import dataset as jds
from ensemble_svs_with_interactions_tpu.data import multitrack as jmt
from ensemble_svs_with_interactions_tpu_torch.data import dataset as ds
from ensemble_svs_with_interactions_tpu_torch.data import multitrack as mt


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return chip_smoke.write_corpus(root, 5, 2, (30, 90), seed=3,
                                   timing_dim=12)


def _dirs(corpus, phase, split="train_no_dev"):
    return (corpus / split / f"in_{phase}", corpus / split / f"out_{phase}")


def _assert_batches_equal(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref) and ref
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("spk_names", [None, list(chip_smoke.CORPUS_SPKS)])
@pytest.mark.parametrize("length_cap", [None, 32])
def test_bucketed_batch_iterator(corpus, length_cap, spk_names):
    """Single-track batches, with and without random crops, with and
    without speaker ids, over two epochs of one iterator."""
    def build(mod):
        if spk_names:
            data = mod.MultiSpeakerFeatsDataset(*_dirs(corpus, "acoustic"),
                                                spk_names, max_frames=80)
        else:
            data = mod.FeatsDataset(*_dirs(corpus, "acoustic"), max_frames=80)
        return mod.BucketedBatchIterator(data, max_tokens=200,
                                         time_multiple=8, batch_multiple=1,
                                         seed=7, length_cap=length_cap)

    got, ref = build(ds), build(jds)
    assert got.batches == ref.batches
    for _ in range(2):
        _assert_batches_equal(got, ref)


@pytest.mark.parametrize("sync,length_cap", [("frames", None),
                                             ("frames", 24),
                                             ("notes", None)])
def test_multitrack_batch_iterator(corpus, sync, length_cap):
    """Frame-synced pairs (with one random window across both tracks) and
    note-merged pairs, over two epochs, shuffled and in order."""
    phase = "acoustic" if sync == "frames" else "duration"
    spks = list(chip_smoke.CORPUS_SPKS)

    def build(mod, shuffle):
        data = mod.MultiTrackFeatsDataset(*_dirs(corpus, phase), spks,
                                          max_frames=85,
                                          load_times=sync == "notes")
        return mod.MultiTrackBatchIterator(
            data, sync=sync, max_tokens=256, time_multiple=8,
            batch_multiple=1, shuffle=shuffle, seed=11,
            length_cap=length_cap)

    for shuffle in (True, False):
        got, ref = build(mt, shuffle), build(jmt, shuffle)
        assert got.batches == ref.batches
        for _ in range(2):
            _assert_batches_equal(got, ref)


def test_pairs_and_lengths(corpus):
    """``pair_multitrack_files`` (i <= j, self-pairs), the per-pair max
    lengths and the post-merge lengths that size note-synced batches."""
    for phase in ("acoustic", "timelag"):
        d = _dirs(corpus, phase)
        got = mt.pair_multitrack_files(*d, max_frames=70)
        assert got == jmt.pair_multitrack_files(*d, max_frames=70)
        segs = {mt.segment_name(a) for (a, _), _ in got}
        assert len(got) == 6 * len(segs)  # 3 singers: 3 self + 3 cross
    spks = list(chip_smoke.CORPUS_SPKS)
    a = mt.MultiTrackFeatsDataset(*_dirs(corpus, "timelag"), spks,
                                  load_times=True)
    b = jmt.MultiTrackFeatsDataset(*_dirs(corpus, "timelag"), spks,
                                   load_times=True)
    np.testing.assert_array_equal(a.lengths(), b.lengths())
    np.testing.assert_array_equal(a.merged_lengths(), b.merged_lengths())
    assert (a.merged_lengths() >= a.lengths()).all()
    assert (a.merged_lengths() > a.lengths()).any()


@pytest.mark.parametrize("time_multiple,batch_multiple", [(1, 1), (8, 1),
                                                          (32, 4)])
def test_pad_batch(time_multiple, batch_multiple):
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(int(n), 5)).astype(np.float32)
              for n in rng.integers(3, 40, 5)]
    for g, r in zip(ds.pad_batch(arrays, time_multiple, batch_multiple),
                    jds.pad_batch(arrays, time_multiple, batch_multiple)):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("max_tokens,max_sentences,multiple",
                         [(100, None, 1), (300, 4, 1), (250, None, 3),
                          (None, 2, 1)])
def test_batch_by_size(max_tokens, max_sentences, multiple):
    lengths = np.random.default_rng(1).integers(5, 60, 40)
    kw = dict(max_tokens=max_tokens, max_sentences=max_sentences,
              required_batch_size_multiple=multiple)
    assert (ds.batch_by_size(lengths, **kw)
            == jds.batch_by_size(lengths, **kw))


def test_prefetch_batches_keeps_order_and_passes_errors():
    """Items arrive in order; an exception in the producer reaches the
    consumer after the items before it; closing the consumer stops the
    producer thread."""
    for depth in (1, 2, 5):
        assert list(ds.prefetch_batches(iter(range(50)), depth)) == list(
            range(50))

    def failing():
        yield from range(3)
        raise KeyError("producer fault")

    got = []
    with pytest.raises(KeyError, match="producer fault"):
        for item in ds.prefetch_batches(failing()):
            got.append(item)
    assert got == [0, 1, 2]

    before = threading.active_count()
    gen = ds.prefetch_batches(iter(range(1000)), depth=2)
    assert next(gen) == 0
    gen.close()
    for t in threading.enumerate():
        if t.name == "batch-prefetch":
            t.join(timeout=5)
    assert threading.active_count() <= before


def test_load_utt_list(tmp_path):
    p = tmp_path / "utts.list"
    p.write_text("a\n\n b \nc\n")
    assert ds.load_utt_list(p) == jds.load_utt_list(p) == ["a", "b", "c"]
