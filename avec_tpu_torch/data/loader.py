"""Data loader: a shuffled, sharded, prefetching batch iterator (port of
avec_tpu/data/loader.py:38-170; the same index order and the same batches).

  * epoch-seeded shuffling: `set_epoch(e)` reseeds with seed + e;
  * per-replica sharding (`num_replicas`, `rank`): indices padded to a
    multiple of the replica count, then strided by rank;
  * `accum` packs accumulated_steps x batch_size samples into one collate
    call, so gradient-accumulation micro-batches share a padded shape;
  * a prefetch thread collates ahead of the consumer; `num_workers` threads
    build the samples of a batch concurrently, batch order unchanged;
  * `bucket_by_length` sorts shuffled indices by `dataset.sample_lengths()`
    inside pools of `bucket_pool_batches` batches before chunking.

A thread's exception is raised again in the consuming thread. A consumer
that stops early (a `steps_per_epoch` cap) stops the prefetch thread and
joins it when the iterator is closed.
"""

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

_PUT_POLL_S = 0.1


class _End:
    """The prefetch thread's last item: whether it yielded every batch, or
    the exception that stopped it."""

    def __init__(self):
        self.complete = False
        self.error: Optional[BaseException] = None


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: Optional[bool] = None,
                 collate_fn=None, drop_last: bool = False, seed: int = 0,
                 num_replicas: int = 1, rank: int = 0, accum: int = 1,
                 prefetch: int = 2, num_workers: int = 0,
                 bucket_by_length: bool = False, bucket_pool_batches: int = 32):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = dataset.shuffle if shuffle is None else shuffle
        self.collate_fn = (collate_fn if collate_fn is not None
                           else dataset.collate_fn)
        self.drop_last = drop_last
        self.seed = seed
        self.num_replicas = num_replicas
        self.rank = rank
        self.accum = accum
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.bucket_by_length = bucket_by_length
        self.bucket_pool_batches = bucket_pool_batches
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Reshuffle seed per epoch (DistributedSampler.set_epoch)."""
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        if self.num_replicas > 1:
            # DistributedSampler: pad to a multiple then stride by rank.
            total = ((n + self.num_replicas - 1) // self.num_replicas
                     * self.num_replicas)
            idx = np.concatenate([idx, idx[: total - n]])
            idx = idx[self.rank::self.num_replicas]
        return idx

    def __len__(self):
        per = self.batch_size * self.accum
        n = len(self._indices())
        return n // per if self.drop_last else (n + per - 1) // per

    def _sample_lengths(self):
        fn = getattr(self.dataset, "sample_lengths", None)
        return fn() if fn is not None else None

    def _batch_index_chunks(self):
        """Index chunks, one per batch; optionally length-bucketed."""
        idx = self._indices()
        per = self.batch_size * self.accum
        end = (len(idx) // per) * per if self.drop_last else len(idx)
        idx = idx[:end]

        if self.bucket_by_length:
            lengths = self._sample_lengths()
            if lengths is not None:
                lengths = np.asarray(lengths)
                pool = per * max(self.bucket_pool_batches, 1)
                chunks = []
                for start in range(0, len(idx), pool):
                    window = idx[start:start + pool]
                    window = window[np.argsort(lengths[window], kind="stable")]
                    chunks.extend(window[o:o + per]
                                  for o in range(0, len(window), per))
                if self.shuffle:   # keep batch-level randomness
                    order = np.random.RandomState(
                        self.seed + self.epoch + 1).permutation(len(chunks))
                    chunks = [chunks[int(i)] for i in order]
                return [c for c in chunks
                        if not (self.drop_last and len(c) < per)]

        return [idx[s:s + per] for s in range(0, len(idx), per)
                if not (self.drop_last and len(idx[s:s + per]) < per)]

    def _iter_batches(self) -> Iterator:
        chunks = self._batch_index_chunks()
        if self.num_workers > 0:
            yield from self._iter_batches_workers(chunks)
            return
        for chunk in chunks:
            samples = [self.dataset[int(i)] for i in chunk]
            yield self.collate_fn(samples)

    def _iter_batches_workers(self, chunks) -> Iterator:
        """Build samples on a thread pool, `prefetch + 1` batches in flight;
        batches are collated and yielded in order."""
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            it = iter(chunks)
            in_flight: deque = deque()

            def submit_next():
                chunk = next(it, None)
                if chunk is not None:
                    in_flight.append([ex.submit(self.dataset.__getitem__,
                                                int(i)) for i in chunk])

            for _ in range(max(self.prefetch, 1) + 1):
                submit_next()
            while in_flight:
                futs = in_flight.popleft()
                samples = [f.result() for f in futs]
                submit_next()
                yield self.collate_fn(samples)

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._iter_batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=_PUT_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            end = _End()
            try:
                for batch in self._iter_batches():
                    if not put(batch):
                        return
                end.complete = True
            except Exception as e:   # raised again by the consumer
                end.error = e
            finally:
                put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, _End):
                    if item.error is not None:
                        raise item.error
                    if not item.complete:
                        raise RuntimeError("the loader's prefetch thread "
                                           "stopped before its last batch")
                    return
                yield item
        finally:
            stop.set()
            t.join()
