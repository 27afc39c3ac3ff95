"""A small seeded LRS2 + LRS3 tree, in the layouts `data/lrs.py` reads, for
the tests and the card check (the licensed data are not in the repository):

    python -m avec_tpu_torch.data.lrs_fixture --root datasets [--seed 0]

writes, under `root`:

  * LRS2: the split lists pretrain.txt, train.txt, val.txt and test.txt
    (test lines carry a second column, as the released list does), and per
    utterance `mvlrs_v1/{pretrain|main}/<speaker>/<id>` + `.txt`,
    the audio and `.json` infos, each split with speakers of its own;
  * LRS3: per utterance `{pretrain|trainval|test}/<speaker>/<id>` + the
    same files;
  * LRS3/tokenizerbpe256.json, a 256-piece BPE tokenizer trained on every
    transcript, which gives the infos' labels, and LRS3/6gram_lrs23.arpa,
    an order-6 ARPA that `decode/ngram.py:estimate_arpa` estimates from the
    labels (words chr(id + 100), as the decoders map them).

Transcripts are seeded lines of random 3-8 letter words ("Text:  ..."
first line, upper case, as released). Audio is seeded noise of 1-3 s at 16
kHz, as .flac in LRS2 val and test and as 16-bit .wav elsewhere; infos
give video_len = audio_len // 640 + 1 (25 fps). With video=True each
utterance also gets a `_mouth.mp4` of 96 x 96 seeded frames (OpenCV).
"""

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np

from avec_tpu_torch.utils import media

LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))
SIZES = {("LRS2", "pretrain"): 32, ("LRS2", "train"): 32,
         ("LRS2", "val"): 8, ("LRS2", "test"): 16,
         ("LRS3", "pretrain"): 32, ("LRS3", "trainval"): 32,
         ("LRS3", "test"): 16}
FLAC_SPLITS = (("LRS2", "val"), ("LRS2", "test"))
NGRAM_OFFSET = 100
NGRAM_ORDER = 6
VOCAB = 256


def _line(rng) -> str:
    return " ".join("".join(rng.choice(LETTERS, rng.randint(3, 9)))
                    for _ in range(rng.randint(2, 7)))


def _base(root: str, version: str, split: str, speaker: str, utt: str):
    if version == "LRS2":
        sub = "pretrain" if split == "pretrain" else "main"
        return os.path.join(root, "LRS2", "mvlrs_v1", sub, speaker, utt)
    return os.path.join(root, "LRS3", split, speaker, utt)


def write_lrs_fixture(root: str, seed: int = 0,
                      sizes: Optional[Dict] = None,
                      seconds=(1.0, 3.0), video: bool = False,
                      corpus_lines: int = 600) -> Dict[str, str]:
    """Write the tree (see the module docstring); returns the paths of the
    tokenizer and the ARPA file. `sizes` maps (version, split) to a number
    of utterances; `corpus_lines` extra seeded lines widen the tokenizer's
    corpus so that BPE reaches its 256 pieces."""
    from avec_tpu_torch.decode.ngram import estimate_arpa
    from avec_tpu_torch.utils.tokenizer import Tokenizer, train_bpe

    sizes = dict(SIZES if sizes is None else sizes)
    rng = np.random.RandomState(seed)
    items = []                                    # (version, split, base, text)
    lists: Dict = {}
    for k, ((version, split), n) in enumerate(sorted(sizes.items())):
        for i in range(n):
            # speakers of their own per split: LRS2's train, val and test
            # utterances share the directory main/
            speaker, utt = f"{5000 + 100 * k + i // 4:05d}", f"{i % 4:05d}"
            base = _base(root, version, split, speaker, utt)
            items.append((version, split, base, _line(rng)))
            lists.setdefault((version, split), []).append(f"{speaker}/{utt}")
    for (version, split), names in lists.items():
        if version == "LRS2":
            os.makedirs(os.path.join(root, "LRS2"), exist_ok=True)
            with open(os.path.join(root, "LRS2", split + ".txt"), "w") as f:
                for name in names:
                    f.write(f"{name} NF\n" if split == "test" else name + "\n")

    corpus = [text for *_, text in items] + [_line(rng)
                                             for _ in range(corpus_lines)]
    tok = Tokenizer(train_bpe(corpus, VOCAB))
    tok_path = os.path.join(root, "LRS3", "tokenizerbpe256.json")
    os.makedirs(os.path.dirname(tok_path), exist_ok=True)
    tok.save(tok_path)

    labels = []
    for version, split, base, text in items:
        os.makedirs(os.path.dirname(base), exist_ok=True)
        with open(base + ".txt", "w") as f:
            f.write(f"Text:  {text.upper()}\nConf:  4\n")
        n = int(rng.randint(int(seconds[0] * 16000),
                            int(seconds[1] * 16000) + 1))
        audio = (rng.randn(n) * 0.1).astype(np.float32)
        ext = ".flac" if (version, split) in FLAC_SPLITS else ".wav"
        media.write_audio(base + ext, audio)
        label = [int(i) for i in tok.encode(text)]
        labels.append(label)
        with open(base + ".json", "w") as f:
            json.dump({"label": label, "video_len": n // 640 + 1,
                       "audio_len": n, "label_len": len(label)}, f)
        if video:
            frames = rng.randint(0, 256, (n // 640 + 1, 96, 96, 3),
                                 dtype=np.uint8)
            media.write_video(base + "_mouth.mp4", frames, 25.0)

    arpa = os.path.join(root, "LRS3", f"{NGRAM_ORDER}gram_lrs23.arpa")
    estimate_arpa([[chr(NGRAM_OFFSET + i) for i in label]
                   for label in labels], arpa, order=NGRAM_ORDER)
    return {"tokenizer": tok_path, "arpa": arpa}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m avec_tpu_torch.data."
                                     "lrs_fixture")
    p.add_argument("--root", default="datasets")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--video", action="store_true",
                   help="also write _mouth.mp4 clips (needs OpenCV)")
    args = p.parse_args(argv)
    paths = write_lrs_fixture(args.root, args.seed, video=args.video)
    print(json.dumps(paths))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
