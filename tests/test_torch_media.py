"""The port's media reading and writing, FLAC codec, data transforms and
`load_av_inputs` against the JAX package's (`avec_tpu/utils/flac.py`,
`avec_tpu/utils/media.py`, `avec_tpu/data/transforms.py`, `demo.py`).

Everything is compared for equality: FLAC files byte for byte both ways,
wav bytes and decoded samples, resampling, grayscale, decoded video frames,
`load_av_inputs`'s arrays, and each transform's output from the same seed.
The video cases need OpenCV (`cv2`) and skip without it; without `cv2` the
port's video functions must raise ImportError.
"""

import os
import sys
import wave

import numpy as np
import pytest

from avec_tpu.data import transforms as jtr
from avec_tpu.utils import flac as jflac
from avec_tpu.utils import media as jmedia
from avec_tpu_torch.data import transforms as tr
from avec_tpu_torch.utils import flac, media


def _signal(kind: str) -> np.ndarray:
    rng = np.random.RandomState(len(kind))
    t = np.arange(16000) / 16000.0
    return {
        "sine": 0.5 * np.sin(2 * np.pi * 440 * t),
        "noise": rng.randn(16000) * 0.2,
        "silence": np.zeros(8192),
        "one_sample": np.array([0.25]),
        "clipped": rng.randn(5000) * 3.0,
        "ragged_blocks": np.sin(np.arange(4097 * 2 + 3) / 7.0) * 0.3,
        "tones": np.concatenate([np.sin(2 * np.pi * f * t[:3000]) * a
                                 for f, a in ((200, 0.1), (3000, 0.9),
                                              (60, 0.5))]),
    }[kind].astype(np.float32)


KINDS = ["sine", "noise", "silence", "one_sample", "clipped",
         "ragged_blocks", "tones"]


@pytest.mark.parametrize("kind", KINDS)
def test_flac_byte_identical_both_ways(tmp_path, kind):
    """The port's and the JAX package's encoders write the same bytes, and
    each decoder reads the other's file to the same samples."""
    x = _signal(kind)
    mine, theirs = str(tmp_path / "p.flac"), str(tmp_path / "j.flac")
    flac.write_flac(mine, x, 16000)
    jflac.write_flac(theirs, x, 16000)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    a, sr_a = flac.read_flac(theirs)
    b, sr_b = jflac.read_flac(mine)
    assert sr_a == sr_b == 16000 and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    q = np.clip(x * 32768.0, -32768, 32767).astype(np.int32) / 32768.0
    np.testing.assert_array_equal(a, q.astype(np.float32))


def test_flac_helpers_match(tmp_path):
    assert flac._crc8(b"123456789") == jflac._crc8(b"123456789") == 0xF4
    assert flac._crc16(b"123456789") == jflac._crc16(b"123456789") == 0xFEE8
    for v in (0, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10000):
        assert flac._utf8_number(v) == jflac._utf8_number(v)


@pytest.mark.parametrize("ext", [".wav", ".flac"])
def test_audio_write_read_identical(tmp_path, ext):
    """write_audio: the same bytes from both packages (16-bit PCM wav, or
    FLAC without soundfile); read_audio: the same samples and rate."""
    x = _signal("tones")
    mine, theirs = str(tmp_path / f"p{ext}"), str(tmp_path / f"j{ext}")
    media.write_audio(mine, x, 16000)
    jmedia.write_audio(theirs, x, 16000)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    a, sr = media.read_audio(theirs)
    b, jsr = jmedia.read_audio(mine)
    assert sr == jsr == 16000 and a.shape == b.shape == x.shape
    np.testing.assert_array_equal(a, b)


def test_wav_32_bit_stereo_reads_identical(tmp_path):
    """A 32-bit two-channel wav at 8 kHz: the first channel, scaled by
    2^-31, in both packages; an 8-bit wav raises ValueError in both."""
    rng = np.random.RandomState(0)
    pcm = rng.randint(-2 ** 31, 2 ** 31 - 1, size=(300, 2)).astype("<i4")
    path = str(tmp_path / "s.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(4)
        f.setframerate(8000)
        f.writeframes(pcm.tobytes())
    a, sr = media.read_audio(path)
    b, jsr = jmedia.read_audio(path)
    assert sr == jsr == 8000 and a.shape == (300,)
    np.testing.assert_array_equal(a, b)
    path8 = str(tmp_path / "b.wav")
    with wave.open(path8, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(1)
        f.setframerate(8000)
        f.writeframes(bytes(range(100)))
    for read in (media.read_audio, jmedia.read_audio):
        with pytest.raises(ValueError):
            read(path8)


@pytest.mark.parametrize("orig_sr", [16000, 8000, 22050, 44100, 48000])
def test_resample_audio_identical(orig_sr):
    x = _signal("noise")[:orig_sr // 2]
    a = media.resample_audio(x, orig_sr, 16000)
    b = jmedia.resample_audio(x, orig_sr, 16000)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgb_to_grayscale_identical(dtype):
    rng = np.random.RandomState(1)
    video = (rng.rand(3, 5, 7, 3) * 255).astype(dtype)
    a, b = media.rgb_to_grayscale(video), jmedia.rgb_to_grayscale(video)
    assert a.shape == (3, 5, 7, 1) and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- video
def _write_mp4(path, frames, fps=25.0):
    cv2 = pytest.importorskip("cv2")
    h, w = frames.shape[1:3]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        wr.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    wr.release()


def _frames(n=12, h=100, w=110, seed=0):
    rng = np.random.RandomState(seed)
    base = (rng.rand(1, h, w, 3) * 255)
    drift = np.arange(n)[:, None, None, None] * 7.0
    return ((base + drift) % 255).astype(np.uint8)


def test_read_video_identical(tmp_path):
    path = str(tmp_path / "clip.mp4")
    _write_mp4(path, _frames())
    a, fps = media.read_video(path)
    b, jfps = jmedia.read_video(path)
    assert a.shape == (12, 100, 110, 3) and fps == jfps == 25.0
    np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        media.read_video(str(tmp_path / "missing.mp4"))


def test_write_video_identical(tmp_path):
    """The port's writer (mp4v) and the JAX package's give files that
    decode to the same frames; a grayscale (T, H, W, 1) clip too."""
    pytest.importorskip("cv2")
    for frames in (_frames(6, 48, 64), _frames(5, 40, 40)[..., :1]):
        mine, theirs = str(tmp_path / "p.mp4"), str(tmp_path / "j.mp4")
        media.write_video(mine, frames, codec="mp4v")
        jmedia.write_video(theirs, frames, codec="mp4v")
        np.testing.assert_array_equal(media.read_video(mine)[0],
                                      jmedia.read_video(theirs)[0])


@pytest.mark.parametrize("audio_s", [None, 0.3, 0.7])
def test_load_av_inputs_identical(tmp_path, audio_s):
    """demo.load_av_inputs on a 12-frame clip: without a .wav beside it,
    with a shorter one (the video cropped) and a longer one at 8 kHz (the
    audio resampled, the video padded)."""
    import demo
    from avec_tpu_torch.demo import load_av_inputs

    path = str(tmp_path / "clip.mp4")
    _write_mp4(path, _frames())
    if audio_s is not None:
        sr = 16000 if audio_s < 0.5 else 8000
        jmedia.write_audio(str(tmp_path / "clip.wav"),
                           _signal("tones")[:int(sr * audio_s)], sr)
    video, audio, fps = load_av_inputs(path)
    jvideo, jaudio, jfps = demo.load_av_inputs(path)
    assert video.shape[1:] == (88, 88, 1) and fps == jfps
    np.testing.assert_array_equal(video, jvideo)
    if audio_s is None:
        assert audio is None and jaudio is None
    else:
        np.testing.assert_array_equal(audio, jaudio)
        assert video.shape[0] == len(audio) // 640 + 1


def test_video_functions_need_cv2(tmp_path, monkeypatch):
    """Without OpenCV, read_video, write_video and load_av_inputs raise
    ImportError naming cv2: no other route."""
    from avec_tpu_torch.demo import load_av_inputs

    monkeypatch.setitem(sys.modules, "cv2", None)
    path = str(tmp_path / "clip.mp4")
    for call in (lambda: media.read_video(path),
                 lambda: media.write_video(path, _frames(2, 8, 8)),
                 lambda: load_av_inputs(path)):
        with pytest.raises(ImportError, match="cv2"):
            call()
    assert not os.path.exists(path)


# ----------------------------------------------------------- transforms
def _video(seed=0, t=20, h=96, w=96):
    return np.random.RandomState(seed).rand(t, h, w, 1).astype(np.float32)


def test_deterministic_transforms_identical():
    v = _video()
    audio = _signal("noise")
    pairs = [
        (tr.NormalizeVideo(), jtr.NormalizeVideo()),
        (tr.DenormalizeVideo((0.4,), (0.2,)),
         jtr.DenormalizeVideo((0.4,), (0.2,))),
        (tr.CenterCrop((88, 88)), jtr.CenterCrop((88, 88))),
        (tr.CenterCrop((87, 85)), jtr.CenterCrop((87, 85))),
        (tr.Compose([tr.NormalizeVideo(), tr.CenterCrop((88, 88))]),
         jtr.Compose([jtr.NormalizeVideo(), jtr.CenterCrop((88, 88))])),
    ]
    for mine, theirs in pairs:
        np.testing.assert_array_equal(mine(v), theirs(v))
    for n in (2000, 12800, 16000, 40000):
        a = tr.align_video_to_audio(v, audio[:n] if n <= 16000
                                    else np.zeros(n, np.float32))
        b = jtr.align_video_to_audio(v, audio[:n] if n <= 16000
                                     else np.zeros(n, np.float32))
        assert a.shape[0] == n // 640 + 1
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_transforms_identical_with_seed(seed):
    """RandomCrop, RandomHorizontalFlip, TimeMaskSecond and BabbleNoise with
    RandomState(seed) in both packages: the same outputs call after call."""
    v = _video(seed, t=60)
    audio = _signal("sine")[:8000]
    noise = _signal("noise")
    mine = [tr.RandomCrop((88, 88), rng=np.random.RandomState(seed)),
            tr.RandomHorizontalFlip(0.5, rng=np.random.RandomState(seed)),
            tr.TimeMaskSecond(0.4, 2.0, rng=np.random.RandomState(seed)),
            tr.TimeMaskSecond(0.4, 2.0, mean_frame=False,
                              rng=np.random.RandomState(seed))]
    theirs = [jtr.RandomCrop((88, 88), rng=np.random.RandomState(seed)),
              jtr.RandomHorizontalFlip(0.5, rng=np.random.RandomState(seed)),
              jtr.TimeMaskSecond(0.4, 2.0, rng=np.random.RandomState(seed)),
              jtr.TimeMaskSecond(0.4, 2.0, mean_frame=False,
                                 rng=np.random.RandomState(seed))]
    for a, b in zip(mine, theirs):
        for _ in range(4):
            np.testing.assert_array_equal(a(v), b(v))
    bn = tr.BabbleNoise(noise=noise, rng=np.random.RandomState(seed))
    jbn = jtr.BabbleNoise(noise=noise, rng=np.random.RandomState(seed))
    outs = [bn(audio) for _ in range(6)]
    for o in outs:
        np.testing.assert_array_equal(o, jbn(audio))
    assert any(not np.array_equal(o, audio) for o in outs)


def test_babble_noise_from_file_identical(tmp_path):
    """BabbleNoise reading its noise from a 8 kHz wav (resampled to 16
    kHz), as the JAX transform does."""
    path = str(tmp_path / "babble.wav")
    jmedia.write_audio(path, _signal("noise")[:8000], 8000)
    audio = _signal("sine")[:4000]
    bn = tr.BabbleNoise(path, SNR_db=(0, 5), rng=np.random.RandomState(3))
    jbn = jtr.BabbleNoise(path, SNR_db=(0, 5), rng=np.random.RandomState(3))
    np.testing.assert_array_equal(bn.noise, jbn.noise)
    np.testing.assert_array_equal(bn(audio), jbn(audio))


def test_random_transforms_take_a_generator():
    """A np.random.Generator: the same seed gives the same results, and
    every draw stays in range (crops inside the frame, masks inside the
    clip)."""
    v = _video(t=40)
    for seed in range(5):
        outs = []
        for _ in range(2):
            g = np.random.default_rng(seed)
            crop = tr.RandomCrop((88, 88), rng=g)(v)
            flip = tr.RandomHorizontalFlip(0.5, rng=g)(v)
            mask = tr.TimeMaskSecond(0.4, 2.0, rng=g)(v)
            outs.append((crop, flip, mask))
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
        assert outs[0][0].shape == (40, 88, 88, 1)
