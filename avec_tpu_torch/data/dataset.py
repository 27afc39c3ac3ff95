"""Dataset bases (port of avec_tpu/data/dataset.py:21-57).

A Dataset carries its own batch_size / collate_fn / shuffle attributes (the
engine and the loader read them); MultiDataset concatenates datasets.
Samples are tuples of numpy arrays.
"""

import bisect
from typing import List, Optional, Sequence


class Dataset:
    """Map-style dataset carrying loader attributes."""

    def __init__(self, batch_size: Optional[int] = None, collate_fn=None,
                 shuffle: bool = True):
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError


class MultiDataset(Dataset):
    """Concatenation of datasets."""

    def __init__(self, datasets: Sequence[Dataset], batch_size=None,
                 collate_fn=None, shuffle: bool = True):
        super().__init__(batch_size=batch_size, collate_fn=collate_fn,
                         shuffle=shuffle)
        self.datasets = list(datasets)
        self._offsets: List[int] = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self._offsets.append(total)

    def __len__(self):
        return self._offsets[-1] if self._offsets else 0

    def __getitem__(self, idx):
        ds_idx = bisect.bisect_right(self._offsets, idx)
        start = self._offsets[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - start]
