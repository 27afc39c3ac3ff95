"""The dataset namespace of the reference's nnet.datasets (port of
avec_tpu/data/datasets.py:1-12)."""

from avec_tpu_torch.data.corpus_lm import CorpusLM  # noqa: F401
from avec_tpu_torch.data.dataset import Dataset, MultiDataset  # noqa: F401
from avec_tpu_torch.data.lrs import LRS  # noqa: F401
from avec_tpu_torch.data.lrw import LRW  # noqa: F401
from avec_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticAVDataset,
    SyntheticClassificationDataset,
    SyntheticLMDataset,
)
