"""Synthetic datasets (port of avec_tpu/data/synthetic.py:24-278): the same
samples for the same seed and index.

Sample tuples follow the LRS dataset contract: the AV sets give the 6-tuple
(video, audio, label, video_len, audio_len, label_len), so the collate specs
of the AV configs apply unchanged. `ToneAVSpeechDataset` backs the AV-Tone
learning run (`avec_tpu_torch/configs/av_tone.py`): audio alone cannot solve
it, since tokens t and t + n_audio_classes sound the same.
"""

import numpy as np

from avec_tpu_torch.data.collate import CollateFn
from avec_tpu_torch.data.dataset import Dataset
from avec_tpu_torch.utils.tokenizer import WORD_BOUNDARY, Tokenizer


class SyntheticAVDataset(Dataset):
    """Random AV samples with LRS-shaped tuples."""

    def __init__(self, num_samples=32, audio_len=16000, video_fps_len=None,
                 label_len=8, vocab_size=256, crop_size=(88, 88),
                 load_video=True, load_audio=True, seed=0, batch_size=None,
                 collate_fn=None, shuffle=True):
        super().__init__(batch_size=batch_size, collate_fn=collate_fn,
                         shuffle=shuffle)
        self.num_samples = num_samples
        self.audio_len = audio_len
        # align_video_to_audio parity: Tv = Ta // 640 + 1
        # (ref transforms.py:169-180).
        self.video_len = (video_fps_len if video_fps_len is not None
                          else audio_len // 640 + 1)
        self.label_len = label_len
        self.vocab_size = vocab_size
        self.crop_size = crop_size
        self.load_video = load_video
        self.load_audio = load_audio
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        a_len = rng.randint(self.audio_len // 2, self.audio_len + 1)
        a_len = max(a_len, 3200)
        v_len = a_len // 640 + 1
        u = rng.randint(1, self.label_len + 1)
        video = (rng.rand(v_len, *self.crop_size, 1).astype(np.float32)
                 if self.load_video else np.zeros((1,), np.float32))
        audio = (rng.randn(a_len).astype(np.float32) * 0.1
                 if self.load_audio else np.zeros((1,), np.float32))
        label = rng.randint(1, self.vocab_size, size=u).astype(np.int32)
        return (video, audio, label,
                np.int32(v_len), np.int32(a_len), np.int32(u))


class SyntheticLMDataset(Dataset):
    """Random token sequences: sample = (ids,) (CorpusLM contract,
    ref datasets.py:602-628)."""

    def __init__(self, num_samples=64, max_length=32, vocab_size=100, seed=0,
                 batch_size=None, collate_fn=None, shuffle=True):
        super().__init__(batch_size=batch_size, collate_fn=collate_fn,
                         shuffle=shuffle)
        self.num_samples = num_samples
        self.max_length = max_length
        self.vocab_size = vocab_size
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        n = rng.randint(4, self.max_length)
        return (rng.randint(1, self.vocab_size, size=n).astype(np.int32),)


class SyntheticClassificationDataset(Dataset):
    """LRW-style fixed-length video classification: (video, label)."""

    def __init__(self, num_samples=16, video_len=29, crop_size=(88, 88),
                 num_classes=500, seed=0, batch_size=None, collate_fn=None,
                 shuffle=True):
        super().__init__(batch_size=batch_size, collate_fn=collate_fn,
                         shuffle=shuffle)
        self.num_samples = num_samples
        self.video_len = video_len
        self.crop_size = crop_size
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        video = rng.rand(self.video_len, *self.crop_size, 1).astype(np.float32)
        label = np.int32(rng.randint(self.num_classes))
        return (video, label)


class ToneSpeechDataset(Dataset):
    """LEARNABLE synthetic 'speech': each token is a 100 ms sinusoid burst at
    a token-specific frequency with 50 ms gaps — the full AO pipeline must
    learn to transcribe it (a self-contained stand-in for the
    license-gated LRS data)."""

    def __init__(self, num_samples=512, vocab_size=32, min_len=2, max_len=8,
                 sr=16000, seed=0, batch_size=16, collate_fn=None,
                 shuffle=True):
        if collate_fn is None:
            collate_fn = CollateFn(
                inputs_params=[{"axis": 0, "padding": True}, {"axis": 1}],
                targets_params=({"axis": 2, "padding": True}, {"axis": 3}))
        super().__init__(batch_size=batch_size, collate_fn=collate_fn,
                         shuffle=shuffle)
        self.num_samples = num_samples
        self.vocab_size = vocab_size
        self.min_len, self.max_len = min_len, max_len
        self.sr = sr
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        n = rng.randint(self.min_len, self.max_len + 1)
        tokens = rng.randint(1, self.vocab_size, size=n).astype(np.int32)
        burst = int(0.1 * self.sr)
        gap = int(0.05 * self.sr)
        t = np.arange(burst) / self.sr
        pieces = []
        for tok in tokens:
            freq = 200.0 + 120.0 * tok
            env = np.hanning(burst)
            pieces.append((np.sin(2 * np.pi * freq * t) * env)
                          .astype(np.float32))
            pieces.append(np.zeros(gap, np.float32))
        audio = np.concatenate(pieces) * 0.3
        true_len = audio.shape[0]
        # fixed shapes; the true lengths mask the padding
        max_audio = self.max_len * (burst + gap)
        audio = np.pad(audio, (0, max_audio - true_len))
        audio += rng.randn(max_audio).astype(np.float32) * 0.01
        tokens_fixed = np.zeros(self.max_len, np.int32)
        tokens_fixed[:n] = tokens
        return (audio.astype(np.float32), np.int32(true_len),
                tokens_fixed, np.int32(n))

    def token_ids(self, idx):
        """Ground-truth token ids of sample idx (same RNG as __getitem__)."""
        rng = np.random.RandomState(self.seed + idx)
        n = rng.randint(self.min_len, self.max_len + 1)
        return rng.randint(1, self.vocab_size, size=n).astype(np.int32)

    def corpus_lines(self, limit=None):
        """Ground-truth transcripts ('w3 w17 ...') — tokenizer/LM training."""
        return [" ".join(f"w{t}" for t in self.token_ids(i))
                for i in range(min(self.num_samples,
                                   limit or self.num_samples))]


class ToneAVSpeechDataset(Dataset):
    """LEARNABLE synthetic AUDIO-VISUAL 'speech' (the AV analogue of
    ToneSpeechDataset, backing the AV-Tone setup, configs/Synthetic/AV-Tone.py
    and avec_tpu_torch/configs/av_tone.py).

    Each token is a 100 ms event with 50 ms gaps:

      * AUDIO carries only the token's acoustic class: frequency depends on
        ``(tok - 1) % n_audio_classes`` — tokens ``t`` and
        ``t + n_audio_classes`` are acoustically IDENTICAL.
      * VIDEO (25 fps, 88x88x1 grayscale, LRS frame geometry) shows a bright
        cell on an 8x8 grid whose position encodes the FULL token id.

    A model therefore cannot reach low WER from audio alone (~50% floor by
    construction); WER collapse requires information to flow through the
    video encoder AND the fusion module — this is the offline proof that the
    video/fusion path trains.

    Tuple layout matches LRS:
    (video, audio, label, video_len, audio_len, label_len), and the video is
    pre-aligned to the audio (Tv = Ta//640 + 1). Shapes are fixed (padded
    to max_len tokens), so every batch has one shape.
    """

    def __init__(self, num_samples=512, vocab_size=32, min_len=2, max_len=8,
                 sr=16000, seed=0, batch_size=16, collate_fn=None,
                 shuffle=True):
        if collate_fn is None:
            # Same spec as the real AV config (configs/LRS23/AV).
            collate_fn = CollateFn(
                inputs_params=[{"axis": 0, "padding": True}, {"axis": 3},
                               {"axis": 1, "padding": True}, {"axis": 4}],
                targets_params=({"axis": 2, "padding": True}, {"axis": 5}))
        super().__init__(batch_size=batch_size, collate_fn=collate_fn,
                         shuffle=shuffle)
        self.num_samples = num_samples
        self.vocab_size = vocab_size
        self.n_audio_classes = max((vocab_size - 1) // 2, 1)
        self.min_len, self.max_len = min_len, max_len
        self.sr = sr
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def token_ids(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        n = rng.randint(self.min_len, self.max_len + 1)
        return rng.randint(1, self.vocab_size, size=n).astype(np.int32)

    def corpus_lines(self, limit=None):
        return [" ".join(f"w{t}" for t in self.token_ids(i))
                for i in range(min(self.num_samples,
                                   limit or self.num_samples))]

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        n = rng.randint(self.min_len, self.max_len + 1)
        tokens = rng.randint(1, self.vocab_size, size=n).astype(np.int32)
        burst = int(0.1 * self.sr)
        gap = int(0.05 * self.sr)
        period = burst + gap
        t = np.arange(burst) / self.sr
        env = np.hanning(burst)

        max_audio = self.max_len * period
        audio = np.zeros(max_audio, np.float32)
        for i, tok in enumerate(tokens):
            # Audio frequency from the AMBIGUOUS acoustic class only.
            acls = 1 + (int(tok) - 1) % self.n_audio_classes
            freq = 200.0 + 120.0 * acls
            audio[i * period: i * period + burst] = (
                np.sin(2 * np.pi * freq * t) * env * 0.3)
        true_len = n * period
        audio += rng.randn(max_audio).astype(np.float32) * 0.01

        # Video: frame f covers samples [f*640, (f+1)*640).
        max_frames = max_audio // 640 + 1
        v_len = true_len // 640 + 1
        video = rng.rand(max_frames, 88, 88, 1).astype(np.float32) * 0.1
        cell = 11  # 88 / 8
        for f in range(max_frames):
            s = f * 640
            i = s // period
            if i < n and (s % period) < burst:
                tok = int(tokens[i]) - 1
                r, c = (tok // 8) * cell, (tok % 8) * cell
                video[f, r: r + cell, c: c + cell, 0] = 1.0

        tokens_fixed = np.zeros(self.max_len, np.int32)
        tokens_fixed[:n] = tokens
        return (video, audio, tokens_fixed,
                np.int32(v_len), np.int32(true_len), np.int32(n))


def tone_tokenizer(vocab_size: int):
    """Word-per-token tokenizer matching ToneSpeechDataset ids."""
    pieces = ["<unk>"] + [f"{WORD_BOUNDARY}w{i}" for i in range(1, vocab_size)]
    return Tokenizer(pieces)
