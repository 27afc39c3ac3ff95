"""The port's data modules vs the JAX package's: datasets, collation and the
loader give bit-identical batches (`np.array_equal`, dtypes equal) for the
same seeds, indices and epochs.

Small sets of the AV-Tone kind (tokens of 2-3 or 2-4, so video of 12-16
frames) keep the file fast; shuffling, `drop_last`, two replicas, `accum`,
worker threads and `bucket_by_length` (over a `sample_lengths()` the test
adds to both packages' sets) run for two epochs each.
"""

import threading

import numpy as np
import pytest

from avec_tpu.data import collate as jcollate
from avec_tpu.data import dataset as jdataset
from avec_tpu.data import loader as jloader
from avec_tpu.data import synthetic as jsynth
from avec_tpu_torch.data import collate as tcollate
from avec_tpu_torch.data import dataset as tdataset
from avec_tpu_torch.data import loader as tloader
from avec_tpu_torch.data import synthetic as tsynth


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield np.asarray(tree)


def _assert_same(got, want):
    assert type(got) is type(want)
    g, w = list(_leaves(got)), list(_leaves(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name, kwargs", [
    ("ToneAVSpeechDataset", dict(num_samples=6, max_len=3, seed=7)),
    ("ToneAVSpeechDataset", dict(num_samples=2, seed=10_000_000)),
    ("ToneSpeechDataset", dict(num_samples=6, max_len=4, seed=3)),
    ("SyntheticAVDataset", dict(num_samples=4, audio_len=6400, seed=1)),
    ("SyntheticLMDataset", dict(num_samples=6, seed=2)),
    ("SyntheticClassificationDataset", dict(num_samples=3, video_len=5,
                                            seed=4)),
])
def test_synthetic_samples_are_identical(name, kwargs):
    got_ds = getattr(tsynth, name)(**kwargs)
    want_ds = getattr(jsynth, name)(**kwargs)
    assert len(got_ds) == len(want_ds)
    for i in range(len(got_ds)):
        _assert_same(got_ds[i], want_ds[i])
    if hasattr(want_ds, "token_ids"):
        for i in range(len(got_ds)):
            assert np.array_equal(got_ds.token_ids(i), want_ds.token_ids(i))
        assert got_ds.corpus_lines() == want_ds.corpus_lines()


def test_collate_and_round_to_bucket_are_identical():
    for n in list(range(0, 70)) + [100, 129, 999, 12345]:
        for g in (4, 8):
            assert tcollate.round_to_bucket(n, g) == \
                jcollate.round_to_bucket(n, g)
    samples = [jsynth.ToneAVSpeechDataset(num_samples=5, max_len=3)[i]
               for i in range(5)]
    specs = [
        (None, None, 8),
        ([{"axis": 0, "padding": True}, {"axis": 3}],
         ({"axis": 2, "padding": True, "start_token": 1, "end_token": 2,
           "padding_value": -1}, {"axis": 5}), 4),
        ({"audio": {"axis": 1, "padding": True}, "len": {"axis": 4}},
         {"label": {"axis": 2, "padding": True}}, 0),
    ]
    for inputs, targets, gran in specs:
        got = tcollate.CollateFn(inputs, targets, gran)(samples)
        want = jcollate.CollateFn(inputs, targets, gran)(samples)
        _assert_same(got, want)
    assert tcollate.Collate()(samples) is samples


def test_multidataset_indexing_is_identical():
    parts = [dict(num_samples=3, max_len=3, seed=0),
             dict(num_samples=2, max_len=3, seed=50)]
    got = tdataset.MultiDataset([tsynth.ToneAVSpeechDataset(**p)
                                 for p in parts])
    want = jdataset.MultiDataset([jsynth.ToneAVSpeechDataset(**p)
                                  for p in parts])
    assert len(got) == len(want) == 5
    for i in range(5):
        _assert_same(got[i], want[i])


class _Lengths:
    """`sample_lengths()` for the length-bucketed loader: each sample's
    token count (drawn as __getitem__ draws it)."""

    def sample_lengths(self):
        return [len(self.token_ids(i)) for i in range(len(self))]


class _PortTone(_Lengths, tsynth.ToneAVSpeechDataset):
    pass


class _JaxTone(_Lengths, jsynth.ToneAVSpeechDataset):
    pass


LOADERS = {
    "shuffle": dict(batch_size=3),
    "drop_last": dict(batch_size=4, drop_last=True),
    "two_replicas": dict(batch_size=2, num_replicas=2, rank=1,
                         drop_last=True),
    "accum_workers": dict(batch_size=2, accum=2, num_workers=2, prefetch=1),
    "bucket_by_length": dict(batch_size=2, bucket_by_length=True,
                             bucket_pool_batches=3, drop_last=True),
    "no_prefetch_eval": dict(batch_size=4, shuffle=False, prefetch=0),
}


@pytest.mark.parametrize("case", sorted(LOADERS))
def test_loader_batches_are_identical_over_two_epochs(case):
    kwargs = LOADERS[case]
    ds = dict(num_samples=11, max_len=3, seed=5, batch_size=kwargs[
        "batch_size"])
    got_ds = (_PortTone if case == "bucket_by_length"
              else tsynth.ToneAVSpeechDataset)(**ds)
    want_ds = (_JaxTone if case == "bucket_by_length"
               else jsynth.ToneAVSpeechDataset)(**ds)
    got = tloader.DataLoader(got_ds, seed=3, **kwargs)
    want = jloader.DataLoader(want_ds, seed=3, **kwargs)
    orders = []
    for epoch in range(2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert len(got) == len(want)
        g, w = list(got), list(want)
        assert len(g) == len(w) == len(want)
        for a, b in zip(g, w):
            _assert_same(a, b)
        orders.append(np.concatenate([b["targets"][0].ravel() for b in g]))
    if got.shuffle:       # epochs reshuffle
        assert not np.array_equal(orders[0], orders[1])


class _Faulty(tsynth.ToneAVSpeechDataset):
    def __getitem__(self, idx):
        if idx == 5:
            raise ValueError("sample 5 is broken")
        return super().__getitem__(idx)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_thread_error_reaches_the_consumer(num_workers):
    """A worker's exception is raised again in the consuming thread; the
    batches before it arrive first, none is dropped silently."""
    loader = tloader.DataLoader(_Faulty(num_samples=8, max_len=2),
                                batch_size=2, shuffle=False,
                                num_workers=num_workers)
    seen = []
    with pytest.raises(ValueError, match="sample 5 is broken"):
        for batch in loader:
            seen.append(batch)
    assert len(seen) == 2


def test_loader_stopped_early_joins_its_thread():
    """A consumer that breaks off (a steps_per_epoch cap) leaves no thread
    blocked on the full queue once the iterator is closed."""
    loader = tloader.DataLoader(
        tsynth.ToneAVSpeechDataset(num_samples=20, max_len=2), batch_size=2,
        prefetch=1)
    before = threading.active_count()
    it = iter(loader)
    next(it)
    assert threading.active_count() == before + 1
    it.close()
    assert threading.active_count() == before
