"""LRS2 / LRS3 audio-visual speech datasets (port of avec_tpu/data/lrs.py:
118-478; the reference's nnet/datasets.py:72-600).

  * path lists from the split files (LRS2 pretrain / train / val /
    test.txt; LRS3 a glob over the mode directories);
  * grayscale + (x - 0.5) / 0.5 video preprocessing;
  * length filtering with a cached {"paths", "lengths"} JSON file (an old
    bare path list is read too), computed on rank 0 and broadcast when a
    process group of more than one rank is up (`parallel/dist.py:
    broadcast_host_object`); `sample_lengths` for the loader's buckets;
  * `__getitem__` -> (video, audio, label, video_len, audio_len,
    label_len): the infos from `.json` or the reference's `.pt`, wav or flac
    audio, the `_mouth.mp4` video through `utils/media.py` (OpenCV; without
    it ImportError naming cv2), `align_video_to_audio` with align=True;
  * `create_corpus`, and `prepare`: per sample the audio as flac, the
    96 x 96 mouth crop from the landmark pickles as `_mouth.mp4`, the infos
    as a torch `.pt` (as the reference and the JAX package write them).

The archives are licensed: `download` raises one error that names the
credentials and the files to place by hand; nothing is fetched.
"""

import glob
import json
import os
from typing import List

import numpy as np
import torch

from avec_tpu_torch.data import transforms as T
from avec_tpu_torch.data.dataset import Dataset
from avec_tpu_torch.parallel import dist as pdist
from avec_tpu_torch.utils import media

# The published sources, named in `download`'s error (datasets.py:368-498):
# the archive parts need the BBC (LRS2) / TED (LRS3) data agreement's
# credentials; the landmark archives are mpc001/Visual_Speech_Recognition_
# for_Multiple_Languages' public Google Drive files.
_LRS_BASE = "https://thor.robots.ox.ac.uk/~vgg/data/lip_reading"
SOURCES = {
    "LRS2": {"archives": [f"lrs2_v1_parta{c}" for c in "abcde"],
             "joined": "lrs2_v1.tar",
             "lists": ["pretrain.txt", "train.txt", "val.txt", "test.txt"],
             "url": f"{_LRS_BASE}/data2/",
             "landmarks": "1G2-rEUNeGotJ9EtTIj0UzqbvCSbn6CJy"},
    "LRS3": {"archives": [f"lrs3_pretrain_parta{c}" for c in "abcdefg"]
             + ["lrs3_trainval.zip", "lrs3_test_v0.4.zip"],
             "joined": "lrs3_pretrain.zip", "lists": [],
             "url": f"{_LRS_BASE}/data3/",
             "landmarks": "1QRdOgeHvmKK8t4hsceFVf_BSpidQfUyW"},
}


def _load_infos(base_path: str) -> dict:
    """Load sample infos: ours (.json) or reference torch pickle (.pt)."""
    if os.path.isfile(base_path + ".json"):
        with open(base_path + ".json") as f:
            infos = json.load(f)
        infos["label"] = np.asarray(infos["label"], dtype=np.int32)
        return infos
    if os.path.isfile(base_path + ".pt"):
        infos = torch.load(base_path + ".pt", map_location="cpu",
                           weights_only=True)
        return {"label": np.asarray(infos["label"], dtype=np.int32),
                "video_len": int(infos["video_len"]),
                "audio_len": int(infos["audio_len"]),
                "label_len": int(infos["label_len"])}
    raise FileNotFoundError(base_path + ".{json,pt}")


def _load_audio_any(base_path: str) -> np.ndarray:
    for ext in (".wav", ".flac"):
        if os.path.isfile(base_path + ext):
            return media.read_audio(base_path + ext)[0]
    raise FileNotFoundError(base_path + ".{wav,flac}")


def _read_label_text(path: str) -> str:
    """First line minus 'Text:  ' prefix, {NS}/{LG} stripped, lowered
    (ref: datasets.py:237)."""
    with open(path) as f:
        line = f.readline()
    return line[7:].replace("{NS}", "").replace("{LG}", "").lower()


class LRS(Dataset):
    def __init__(self, batch_size, collate_fn, version="LRS2", img_mean=(0.5,),
                 img_std=(0.5,), crop_mouth=True, root="datasets", shuffle=True,
                 ascending=False, mode="pretrain+train+val", load_audio=True,
                 load_video=True, video_transform=None, audio_transform=None,
                 download=False, prepare=False, workers_prepare=-1,
                 video_max_length=None, audio_max_length=None,
                 label_max_length=None,
                 tokenizer_path="datasets/LRS3/tokenizerbpe256.json",
                 mean_face_path="media/20words_mean_face.npy", align=False):
        super().__init__(batch_size=batch_size, collate_fn=collate_fn,
                         shuffle=shuffle and not ascending)
        assert version in ("LRS2", "LRS3")
        self.version = version
        self.root = root
        self.mode = mode
        self.ascending = ascending
        self.load_audio = load_audio
        self.load_video = load_video
        self.video_max_length = video_max_length
        self.audio_max_length = audio_max_length
        self.label_max_length = label_max_length
        self.tokenizer_path = tokenizer_path
        self.crop_mouth = crop_mouth
        self.mean_face_path = mean_face_path
        self.align = align
        self.normalize = T.NormalizeVideo(img_mean, img_std)
        self.video_transform = video_transform
        self.audio_transform = audio_transform

        if download:
            self.download()
        if prepare:
            self.prepare(workers_prepare)

        self.paths: List[str] = []
        if version == "LRS2":
            assert mode in ("pretrain+train+val", "pretrain+train", "pretrain",
                            "train", "val", "test")
            split_dirs = {"pretrain": "pretrain", "train": "main",
                          "val": "main", "test": "main"}
            for split in mode.split("+"):
                with open(os.path.join(root, "LRS2", split + ".txt")) as f:
                    for line in f:
                        name = line.split()[0] if split == "test" else line.strip()
                        self.paths.append(os.path.join(
                            root, "LRS2", "mvlrs_v1", split_dirs[split], name))
        else:
            assert mode in ("pretrain+trainval", "pretrain", "trainval", "test")
            for m in mode.split("+"):
                for p in glob.glob(os.path.join(root, "LRS3", m, "*", "*.txt")):
                    self.paths.append(p[:-4])

        # Filter on rank 0 then broadcast (ref: datasets.py:202-219).
        if pdist.world_size() > 1:
            if pdist.rank() == 0:
                self.filter()
            self.paths, self._lengths = pdist.broadcast_host_object(
                (self.paths, getattr(self, "_lengths", None)), root=0)
        else:
            self.filter()

    # -------------------------------------------------------------- filter
    def filter(self):
        """Length-based filtering with a cached path file
        (ref: datasets.py:281-320)."""
        if (self.video_max_length is None and self.audio_max_length is None
                and self.label_max_length is None):
            return
        vmax = self.video_max_length or float("inf")
        amax = self.audio_max_length or float("inf")
        lmax = self.label_max_length or float("inf")
        cache = os.path.join(
            self.root, self.version,
            f"mode_{self.mode}_video_max_length_{vmax}_audio_max_length_{amax}"
            f"_label_max_length_{lmax}_paths.json")
        if os.path.isfile(cache):
            with open(cache) as f:
                cached = json.load(f)
            # Old-style cache: bare path list; new-style: {paths, lengths}.
            if isinstance(cached, dict):
                paths, lengths = cached["paths"], cached["lengths"]
            else:
                paths, lengths = cached, None
        else:
            paths, lengths = [], []
            for path in self.paths:
                infos = _load_infos(path)
                if (infos["video_len"] <= vmax and infos["audio_len"] <= amax
                        and infos["label_len"] <= lmax):
                    paths.append(path)
                    lengths.append(int(infos["audio_len"]))
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            with open(cache, "w") as f:
                json.dump({"paths": paths, "lengths": lengths}, f)
        # Curriculum option: sort by duration (ref datasets.py:318-320;
        # works here also on cache hits).
        if self.ascending and lengths is not None:
            order = sorted(range(len(paths)), key=lambda i: lengths[i])
            paths = [paths[i] for i in order]
            lengths = [lengths[i] for i in order]
        self.paths = paths
        self._lengths = lengths

    def sample_lengths(self):
        """Per-sample audio lengths (from the filter cache) for the loader's
        length-bucketed batching; None when the filter never ran."""
        lengths = getattr(self, "_lengths", None)
        return lengths if lengths and len(lengths) == len(self.paths) else None

    def __len__(self):
        return len(self.paths)

    # ------------------------------------------------------------- getitem
    def __getitem__(self, n):
        path = self.paths[n]
        infos = _load_infos(path)
        label = np.asarray(infos["label"], dtype=np.int32)
        video_len = int(infos["video_len"])
        audio_len = int(infos["audio_len"])
        label_len = int(infos["label_len"])

        audio = None
        if self.load_audio:
            audio = _load_audio_any(path).astype(np.float32)
            if self.audio_transform is not None:
                audio = self.audio_transform(audio)

        video = np.zeros((1,), np.float32)
        if self.load_video:
            suffix = "_mouth.mp4" if self.crop_mouth else ".mp4"
            frames, _ = media.read_video(path + suffix)
            video = media.rgb_to_grayscale(frames).astype(np.float32) / 255.0
            video = self.normalize(video)  # (T, H, W, 1)
            if self.video_transform is not None:
                video = self.video_transform(video)
            if self.align and audio is not None:
                video = T.align_video_to_audio(video, audio)
                video_len = video.shape[0]
        if audio is None:
            audio = np.zeros((1,), np.float32)

        return (video, audio, label, np.int32(video_len),
                np.int32(audio_len), np.int32(label_len))

    # -------------------------------------------------------------- corpus
    def create_corpus(self, mode):
        """ref: datasets.py:221-267."""
        corpus_path = os.path.join(self.root, self.version,
                                   f"corpus_{mode}.txt")
        if os.path.isfile(corpus_path):
            return corpus_path
        print(f"Create Corpus File: {self.version} {mode}")
        with open(corpus_path, "w") as corpus_file:
            if self.version == "LRS2":
                split_dirs = {"pretrain": "pretrain", "train": "main",
                              "val": "main", "test": "main"}
                with open(os.path.join(self.root, "LRS2", mode + ".txt")) as f:
                    for line in f:
                        name = line.split()[0] if mode == "test" else line.strip()
                        txt = os.path.join(self.root, "LRS2", "mvlrs_v1",
                                           split_dirs[mode], name + ".txt")
                        corpus_file.write(_read_label_text(txt))
            else:
                for txt in glob.glob(os.path.join(self.root, "LRS3", mode,
                                                  "*", "*.txt")):
                    corpus_file.write(_read_label_text(txt))
        return corpus_path

    # ------------------------------------------------------------ download
    def download(self):
        """The licensed archives are placed by hand (the JAX package's
        `download`, `_download_file` and `_download_landmarks`, lrs.py:
        290-368, fetch them): this raises RuntimeError naming the
        credentials and the files."""
        src = SOURCES[self.version]
        dest = os.path.join(self.root, self.version)
        joined = ("cat them into " + src["joined"] + " and extract it there"
                  if self.version == "LRS2" else
                  "cat the pretrain parts into " + src["joined"]
                  + " and extract every zip there")
        lists = (", and the file lists " + ", ".join(src["lists"])
                 if src["lists"] else "")
        raise RuntimeError(
            f"{self.version} is not downloaded by this package: with the "
            f"{'BBC' if self.version == 'LRS2' else 'TED'} data agreement's "
            f"credentials ({self.version}_USERNAME / {self.version}"
            f"_PASSWORD), fetch {', '.join(src['archives'])} from "
            f"{src['url']} into {dest}/, {joined}{lists}; put the landmark "
            f"archive (Google Drive id {src['landmarks']}) at "
            f"{dest}/{self.version}_landmarks.zip and extract it to "
            f"{dest}/{self.version}_landmarks/; then build the dataset with "
            f"prepare=True.")

    # ------------------------------------------------------------- prepare
    def prepare(self, workers=-1):
        """Offline pipeline: per sample write {path}.wav (audio),
        {path}_mouth.mp4 (96x96 mouth crop from landmark pickles) and
        {path}.json infos (ref: datasets.py:508-600)."""
        from avec_tpu_torch.data.lipcrop import LipCrop
        from avec_tpu_torch.utils.tokenizer import load_tokenizer

        # Build corpora + tokenizer first (ref: datasets.py:564-584).
        if self.version == "LRS2":
            modes = ["pretrain", "train", "val", "test"]
        else:
            modes = ["pretrain", "trainval", "test"]
        for m in modes:
            self.create_corpus(m)
        tokenizer = load_tokenizer(self.tokenizer_path)

        lipcrop = LipCrop(self.mean_face_path)
        sample_paths = self._all_sample_paths()
        for path in sample_paths:
            self._prepare_sample(path, tokenizer, lipcrop)

    def _all_sample_paths(self):
        if self.version == "LRS2":
            out = []
            for split, sub in (("pretrain", "pretrain"), ("train", "main"),
                               ("val", "main"), ("test", "main")):
                fname = os.path.join(self.root, "LRS2", split + ".txt")
                if not os.path.isfile(fname):
                    continue
                with open(fname) as f:
                    for line in f:
                        name = line.split()[0] if split == "test" else line.strip()
                        out.append(os.path.join(self.root, "LRS2", "mvlrs_v1",
                                                sub, name))
            return out
        return [p[:-4] for m in ("pretrain", "trainval", "test")
                for p in glob.glob(os.path.join(self.root, "LRS3", m, "*",
                                                "*.txt"))]

    def _prepare_sample(self, path, tokenizer, lipcrop):
        import pickle

        from avec_tpu_torch.data.lipcrop import landmarks_interpolate

        if os.path.isfile(path + ".json") or os.path.isfile(path + ".pt"):
            return
        frames, fps = media.read_video(path + ".mp4")
        # Audio extraction from mp4 needs ffmpeg; reference-prepared .flac or
        # pre-extracted .wav are used when present.
        try:
            audio = _load_audio_any(path)
        except FileNotFoundError:
            audio = self._extract_audio(path)
        # Artifact-format parity with the reference prepare
        # (nnet/datasets.py:532): audio is stored as FLAC (native encoder
        # when soundfile is absent, utils/flac.py).
        media.write_audio(path + ".flac", audio)

        # Landmark pickles are the primary crop route (datasets.py:534-543).
        pkl = path.replace(os.path.join(self.root, self.version),
                           os.path.join(self.root, self.version,
                                        self.version + "_landmarks")) + ".pkl"
        if os.path.isfile(pkl):
            with open(pkl, "rb") as f:
                landmarks = pickle.load(f)
            landmarks = landmarks_interpolate(landmarks)
            crop = lipcrop.crop_patch(frames, landmarks)
        else:
            try:
                crop = lipcrop(frames)
            except RuntimeError:
                import cv2

                crop = np.stack([cv2.resize(fr, (96, 96)) for fr in frames])
        media.write_video(path + "_mouth.mp4", crop.astype(np.uint8), fps)

        text = _read_label_text(path + ".txt")
        label = tokenizer.encode(text)
        infos = {"label": [int(i) for i in label],
                 "video_len": int(crop.shape[0]),
                 "audio_len": int(audio.shape[0]),
                 "label_len": int(len(label))}
        # the reference's torch pickle (nnet/datasets.py:558, a LongTensor
        # label), read back in __getitem__ (:341)
        torch.save({"label": torch.tensor(infos["label"], dtype=torch.long),
                    "video_len": infos["video_len"],
                    "audio_len": infos["audio_len"],
                    "label_len": infos["label_len"]}, path + ".pt")

    def _extract_audio(self, path):
        import shutil
        import subprocess

        if shutil.which("ffmpeg") is None:
            raise RuntimeError(
                f"no audio next to {path}.mp4 and ffmpeg unavailable")
        out = path + ".wav"
        subprocess.run(["ffmpeg", "-y", "-i", path + ".mp4", "-vn", "-ac", "1",
                        "-ar", "16000", out], check=True,
                       capture_output=True)
        return media.read_audio(out)[0]
