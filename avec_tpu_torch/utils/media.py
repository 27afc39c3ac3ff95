"""Host-side media reading and writing (port of avec_tpu/utils/media.py).

Audio goes through the stdlib `wave` module (16-bit PCM wav) and, for
flac, through soundfile where it is installed, else the port's own codec
(`utils/flac.py`). Video goes through OpenCV, imported when a video
function is called: without `cv2` those functions raise ImportError, and
there is no other route.
"""

import os
import wave
from typing import Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading or writing video needs OpenCV (cv2), "
                          "which is not installed") from e
    return cv2


def read_video(path: str) -> Tuple[np.ndarray, float]:
    """Decode a video to (T, H, W, 3) uint8 RGB frames and its fps."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames), fps


_H264_FOURCC = None  # resolved on first write: fourcc str, or "" if none


def _h264_fourcc(cv2):
    """Probe once for a working H.264 encoder: OpenCV builds with
    openh264/ffmpeg take 'avc1'/'H264'; builds without one write empty
    files, so the probe writes a real frame to a temporary file."""
    global _H264_FOURCC
    if _H264_FOURCC is not None:
        return _H264_FOURCC
    import tempfile

    for code in ("avc1", "H264", "X264"):
        fd, tmp = tempfile.mkstemp(suffix=".mp4")
        os.close(fd)
        try:
            wr = cv2.VideoWriter(tmp, cv2.VideoWriter_fourcc(*code),
                                 25.0, (32, 32))
            ok = wr.isOpened()
            if ok:
                wr.write(np.zeros((32, 32, 3), np.uint8))
            wr.release()
            if ok and os.path.getsize(tmp) > 0:
                _H264_FOURCC = code
                return code
        except Exception:
            pass
        finally:
            os.unlink(tmp)
    _H264_FOURCC = ""
    return ""


def write_video(path: str, video: np.ndarray, fps: float = 25.0,
                codec: str = "h264"):
    """Encode (T, H, W, 3|1) uint8 frames to mp4; codec "h264" takes an
    H.264 encoder where the OpenCV build has one, else mp4v."""
    cv2 = _cv2()
    if video.ndim == 3:
        video = video[..., None]
    if video.shape[-1] == 1:
        video = np.repeat(video, 3, axis=-1)
    _, h, w, _ = video.shape
    code = (_h264_fourcc(cv2) or "mp4v") if codec == "h264" else codec
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*code), fps, (w, h))
    for frame in video:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Mono float32 audio in [-1, 1] and its sample rate: .wav natively
    (16- or 32-bit PCM, the first channel), anything else through
    soundfile where installed, else .flac through `utils/flac.py`."""
    if path.endswith(".wav"):
        with wave.open(path, "rb") as f:
            sr = f.getframerate()
            n = f.getnframes()
            width = f.getsampwidth()
            channels = f.getnchannels()
            raw = f.readframes(n)
        if width == 2:
            audio = (np.frombuffer(raw, dtype=np.int16).astype(np.float32)
                     / 32768.0)
        elif width == 4:
            audio = (np.frombuffer(raw, dtype=np.int32).astype(np.float32)
                     / 2147483648.0)
        else:
            raise ValueError(f"unsupported sample width {width}")
        if channels > 1:
            audio = audio.reshape(-1, channels)[:, 0]
        return audio.reshape(-1), sr
    try:
        import soundfile as sf

        audio, sr = sf.read(path, dtype="float32")
        if audio.ndim > 1:
            audio = audio[:, 0]
        return audio, sr
    except ImportError:
        pass
    if path.endswith(".flac"):
        from avec_tpu_torch.utils.flac import read_flac

        return read_flac(path)
    raise ImportError(f"cannot read {path}: non-wav/flac audio requires "
                      "soundfile")


def write_audio(path: str, audio: np.ndarray, sample_rate: int = 16000):
    """Write mono float32 [-1, 1] audio: FLAC where the path ends in .flac
    (soundfile where installed, else `utils/flac.py`), else 16-bit PCM
    wav."""
    if path.endswith(".flac"):
        try:
            import soundfile as sf

            sf.write(path, np.asarray(audio, np.float32), sample_rate)
            return
        except ImportError:
            from avec_tpu_torch.utils.flac import write_flac

            write_flac(path, audio, sample_rate)
            return
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def resample_audio(audio: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy's resample_poly) to float32."""
    if orig_sr == new_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, new_sr)
    return resample_poly(audio, new_sr // g, orig_sr // g).astype(np.float32)


def rgb_to_grayscale(video: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) -> (T, H, W, 1) float32, ITU-R 601 weights
    (0.2989 R + 0.587 G + 0.114 B)."""
    w = np.array([0.2989, 0.587, 0.114], dtype=np.float32)
    return (video.astype(np.float32) * w).sum(axis=-1, keepdims=True)
