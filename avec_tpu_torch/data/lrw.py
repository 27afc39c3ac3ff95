"""LRW 500-word lipreading classification dataset (port of avec_tpu/data/
lrw.py:29-97; the reference's nnet/datasets.py:630-837).

The class of a clip is the index of its word among the sorted
`lipread_mp4` directories; a sample is (video (29, H, W, 1) grayscale,
normalized, transformed; label). `prepare` writes each clip's 96 x 96 mouth
crop as `_mouth.mp4` (`data/lipcrop.py`; a resize without the detectors).
The archive is licensed and placed by hand.
"""

import glob
import os

import numpy as np

from avec_tpu_torch.data import transforms as T
from avec_tpu_torch.data.dataset import Dataset
from avec_tpu_torch.utils import media


class LRW(Dataset):
    def __init__(self, batch_size, collate_fn, root="datasets", shuffle=True,
                 mode="train", img_mean=(0.5,), img_std=(0.5,),
                 crop_mouth=True, load_audio=True, load_video=True,
                 video_transform=None, download=False, prepare=False,
                 mean_face_path="media/20words_mean_face.npy",
                 workers_prepare=-1):
        super().__init__(batch_size=batch_size, collate_fn=collate_fn,
                         shuffle=shuffle)
        assert mode in ("train", "val", "test")
        self.root = root
        self.mode = mode
        self.crop_mouth = crop_mouth
        self.load_audio = load_audio
        self.load_video = load_video
        self.mean_face_path = mean_face_path
        self.normalize = T.NormalizeVideo(img_mean, img_std)
        self.video_transform = video_transform

        if download:
            raise RuntimeError(
                "LRW must be downloaded manually (BBC license): "
                "https://www.robots.ox.ac.uk/~vgg/data/lip_reading/lrw1.html")
        if prepare:
            self.prepare(workers_prepare)

        # Class dict from sorted class dirs (ref: datasets.py:668-673).
        self.class_dict = {}
        for i, path in enumerate(sorted(glob.glob(
                os.path.join(root, "LRW", "lipread_mp4", "*")))):
            c = os.path.basename(path)
            self.class_dict[i] = c
            self.class_dict[c] = i

        self.paths = [p[:-4] for p in glob.glob(os.path.join(
            root, "LRW", "lipread_mp4", "*", mode, "*[0-9].mp4"))]

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, n):
        path = self.paths[n]
        suffix = "_mouth.mp4" if self.crop_mouth else ".mp4"
        frames, _ = media.read_video(path + suffix)
        video = media.rgb_to_grayscale(frames).astype(np.float32) / 255.0
        video = self.normalize(video)
        if self.video_transform is not None:
            video = self.video_transform(video)
        label = np.int32(self.class_dict[path.split(os.sep)[-3]])
        return (video, label)

    def prepare(self, workers=-1):
        """Mouth-crop all mp4s to *_mouth.mp4 (ref: datasets.py:721-782)."""
        from avec_tpu_torch.data.lipcrop import LipCrop

        lipcrop = LipCrop(self.mean_face_path)
        for path in glob.glob(os.path.join(self.root, "LRW", "lipread_mp4",
                                           "*", "*", "*[0-9].mp4")):
            base = path[:-4]
            if os.path.isfile(base + "_mouth.mp4"):
                continue
            frames, fps = media.read_video(path)
            try:
                crop = lipcrop(frames)
            except RuntimeError:
                import cv2

                crop = np.stack([cv2.resize(fr, (96, 96)) for fr in frames])
            media.write_video(base + "_mouth.mp4", crop.astype(np.uint8), fps)
