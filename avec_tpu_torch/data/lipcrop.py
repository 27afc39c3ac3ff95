"""Prepare-time mouth crops (port of avec_tpu/data/lipcrop.py:29-198).

The reference's `LipDetectCrop` (nnet/transforms.py:182-388): landmarks
interpolated over the frames that have none, a similarity transform of 5
stable landmarks onto a mean face (the Umeyama estimate, in numpy), the
frame warped by `cv2.warpAffine` (OpenCV, imported when a frame is warped:
without it, ImportError naming cv2), and a 96 x 96 crop around the lip
landmarks 48:68 smoothed over a window of 12 frames. The RetinaFace / FAN
detectors of the ibug packages are optional: `detect_landmarks` without them
raises `DetectorsUnavailable`, an ImportError naming the packages that is
also a RuntimeError, as the JAX package's error is (the prepare routes take
landmark pickles first and fall back to a resize on it).
"""

import collections
from typing import List, Optional

import numpy as np


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform src -> dst; returns 2x3 matrix.

    Equivalent to skimage.transform.estimate_transform('similarity', ...)
    (Umeyama 1991) as used at transforms.py:271.
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    src_c, dst_c = src - mu_s, dst - mu_d
    cov = dst_c.T @ src_c / src.shape[0]
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    diag = np.diag([1.0, d])
    var_s = (src_c ** 2).sum() / src.shape[0]
    scale = np.trace(np.diag(s) @ diag) / var_s
    rot = scale * (u @ diag @ vt)
    t = mu_d - rot @ mu_s
    return np.concatenate([rot, t[:, None]], axis=1)  # 2x3


def apply_similarity(matrix: np.ndarray, points: np.ndarray) -> np.ndarray:
    return points @ matrix[:, :2].T + matrix[:, 2]


def warp_frame(frame: np.ndarray, matrix: np.ndarray, std_size) -> np.ndarray:
    """cv2.warpAffine of a (H, W[, C]) uint8 frame to std_size (rows, cols)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("warping a frame for the mouth crop needs OpenCV "
                          "(cv2), which is not installed") from e

    return cv2.warpAffine(frame, matrix.astype(np.float32),
                          (std_size[1], std_size[0]))


def linear_interpolate(landmarks: List, start_idx: int, stop_idx: int) -> List:
    """ref: transforms.py:251-262."""
    start, stop = landmarks[start_idx], landmarks[stop_idx]
    delta = stop - start
    for idx in range(1, stop_idx - start_idx):
        landmarks[start_idx + idx] = start + idx / float(stop_idx - start_idx) * delta
    return landmarks


def landmarks_interpolate(landmarks: List) -> Optional[List]:
    """Fill missing (None) frames by interpolation/extension
    (ref: transforms.py:230-249)."""
    valid = [i for i, lm in enumerate(landmarks) if lm is not None]
    if not valid:
        return None
    for k in range(1, len(valid)):
        if valid[k] - valid[k - 1] > 1:
            landmarks = linear_interpolate(landmarks, valid[k - 1], valid[k])
    valid = [i for i, lm in enumerate(landmarks) if lm is not None]
    landmarks[: valid[0]] = [landmarks[valid[0]]] * valid[0]
    landmarks[valid[-1]:] = [landmarks[valid[-1]]] * (len(landmarks) - valid[-1])
    assert all(lm is not None for lm in landmarks), "not every frame has landmark"
    return landmarks


def cut_patch(img: np.ndarray, landmarks: np.ndarray, height: int, width: int,
              threshold: int = 5) -> np.ndarray:
    """Crop a (2*height, 2*width) patch centered on landmark mean
    (ref: transforms.py:289-319)."""
    center_x, center_y = np.mean(landmarks, axis=0)
    if center_y - height < 0:
        center_y = height
    if center_y - height < 0 - threshold:
        raise Exception("too much bias in height")
    if center_x - width < 0:
        center_x = width
    if center_x - width < 0 - threshold:
        raise Exception("too much bias in width")
    if center_y + height > img.shape[0]:
        center_y = img.shape[0] - height
    if center_y + height > img.shape[0] + threshold:
        raise Exception("too much bias in height")
    if center_x + width > img.shape[1]:
        center_x = img.shape[1] - width
    if center_x + width > img.shape[1] + threshold:
        raise Exception("too much bias in width")
    return np.copy(img[int(round(center_y) - round(height)):
                       int(round(center_y) + round(height)),
                       int(round(center_x) - round(width)):
                       int(round(center_x) + round(width))])


class DetectorsUnavailable(ImportError, RuntimeError):
    """The ibug face and landmark detectors are not installed."""


class LipCrop:
    """Landmark-driven mouth crop (ref: transforms.py:182-388)."""

    def __init__(self, mean_face_landmarks_path: str, start_idx: int = 48,
                 stop_idx: int = 68, crop_width: int = 96, crop_height: int = 96,
                 window_margin: int = 12, std_size=(256, 256),
                 stable_points=(33, 36, 39, 42, 45)):
        self.mean_face = np.load(mean_face_landmarks_path)
        self.start_idx = start_idx
        self.stop_idx = stop_idx
        self.crop_width = crop_width
        self.crop_height = crop_height
        self.window_margin = window_margin
        self.std_size = std_size
        self.stable_points = list(stable_points)
        self._face_detector = None
        self._landmark_detector = None

    def _init_detectors(self):
        """Optional ibug RetinaFace + FAN detectors (ref :206-211)."""
        if self._face_detector is not None:
            return True
        try:
            from ibug.face_detection import RetinaFacePredictor
            from ibug.face_alignment import FANPredictor

            self._face_detector = RetinaFacePredictor(
                device="cpu", threshold=0.8,
                model=RetinaFacePredictor.get_model("resnet50"))
            self._landmark_detector = FANPredictor(device="cpu", model=None)
            return True
        except Exception:
            return False

    def detect_landmarks(self, video: np.ndarray) -> List:
        if not self._init_detectors():
            raise DetectorsUnavailable(
                "ibug face detectors unavailable (the ibug.face_detection "
                "and ibug.face_alignment packages); use precomputed landmark "
                "pickles (the primary prepare route, datasets.py:534-543)")
        out = []
        for frame in video:
            faces = self._face_detector(frame, rgb=True)
            landmarks, _ = self._landmark_detector(frame, faces, rgb=True)
            out.append(landmarks[0] if len(landmarks) > 0 else None)
        return out

    def crop_patch(self, video: np.ndarray, landmarks: List) -> Optional[np.ndarray]:
        """Sliding-window-smoothed warp + mouth crop (ref :321-379)."""
        num_frames = video.shape[0]
        margin = min(num_frames, self.window_margin)
        q_frame: collections.deque = collections.deque()
        q_landmarks: collections.deque = collections.deque()
        sequence = []
        trans = None
        for frame_idx in range(num_frames):
            q_landmarks.append(landmarks[frame_idx])
            q_frame.append(video[frame_idx])
            if len(q_frame) == margin:
                smoothed = np.mean(q_landmarks, axis=0)
                cur_landmarks = q_landmarks.popleft()
                cur_frame = q_frame.popleft()
                trans = umeyama_similarity(
                    smoothed[self.stable_points, :],
                    self.mean_face[self.stable_points, :])
                trans_frame = warp_frame(cur_frame, trans, self.std_size)
                trans_landmarks = apply_similarity(trans, cur_landmarks)
                sequence.append(cut_patch(
                    trans_frame, trans_landmarks[self.start_idx:self.stop_idx],
                    self.crop_height // 2, self.crop_width // 2))
            if frame_idx == len(landmarks) - 1:
                while q_frame:
                    cur_frame = q_frame.popleft()
                    trans_frame = warp_frame(cur_frame, trans, self.std_size)
                    trans_landmarks = apply_similarity(trans, q_landmarks.popleft())
                    sequence.append(cut_patch(
                        trans_frame,
                        trans_landmarks[self.start_idx:self.stop_idx],
                        self.crop_height // 2, self.crop_width // 2))
                return np.asarray(sequence)
        return None

    def __call__(self, video: np.ndarray) -> np.ndarray:
        landmarks = self.detect_landmarks(video)
        landmarks = landmarks_interpolate(landmarks)
        return self.crop_patch(video, landmarks)
