"""Text LM dataset over a corpus file (port of avec_tpu/data/corpus_lm.py:
24-50): one sample per line, tokenized lower-cased; a line longer than
`max_length` tokens is replaced by another line drawn with a
`RandomState(0)` of the dataset's own, until one fits.
"""

from typing import Optional

import numpy as np

from avec_tpu_torch.data.dataset import Dataset
from avec_tpu_torch.utils.tokenizer import load_tokenizer


class CorpusLM(Dataset):
    def __init__(self, batch_size, collate_fn, root="datasets", shuffle=True,
                 tokenizer_path="datasets/LRS3/tokenizerbpe1024.json",
                 max_length: Optional[int] = None,
                 corpus_path="datasets/LibriSpeechCorpus/"
                             "librispeech-lm-norm.txt"):
        super().__init__(batch_size=batch_size, collate_fn=collate_fn,
                         shuffle=shuffle)
        self.root = root
        self.max_len = max_length
        self.tokenizer = (load_tokenizer(tokenizer_path)
                          if isinstance(tokenizer_path, str)
                          else tokenizer_path)
        with open(corpus_path) as f:
            self.corpus = f.readlines()
        self._rng = np.random.RandomState(0)

    def __len__(self):
        return len(self.corpus)

    def _ids(self, i):
        return self.tokenizer.encode(self.corpus[i].replace("\n", "").lower())

    def __getitem__(self, i):
        if self.max_len:
            while len(self._ids(i)) > self.max_len:
                i = int(self._rng.randint(0, len(self)))
        return (np.asarray(self._ids(i), dtype=np.int32),)
