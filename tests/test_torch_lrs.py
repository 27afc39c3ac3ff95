"""The port's LRS2 / LRS3 and LRW datasets and the mouth crop
(`avec_tpu_torch/data/{lrs,lrw,lipcrop,datasets}.py`) vs the JAX package's
(`avec_tpu/data/`), on fixtures generated here: `data/lrs_fixture.py`'s
tree (both layouts, flac and wav audio, json infos, 96 x 96 mp4 clips
through OpenCV, a 256-piece tokenizer), a raw clip per split with landmark
pickles (some frames without landmarks) and a seeded mean face for
`prepare`, and LRW clips.

Everything is compared exactly: the items (with seeded transforms: random
crop, flip, time mask; `align`), the filter's cache file, `create_corpus`'s
bytes, what `prepare` writes (infos, audio bytes, the decoded mouth clips,
the corpora), the LRW items and `prepare`'s resized clips, and each lipcrop
function on seeded inputs.
"""

import filecmp
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from avec_tpu.data import lipcrop as jlip
from avec_tpu.data import transforms as jT
from avec_tpu.data.lrs import LRS as JaxLRS
from avec_tpu.data.lrw import LRW as JaxLRW
from avec_tpu_torch.data import datasets
from avec_tpu_torch.data import lipcrop as plip
from avec_tpu_torch.data import lrs as plrs
from avec_tpu_torch.data import transforms as pT
from avec_tpu_torch.data.lrs_fixture import write_lrs_fixture
from avec_tpu_torch.utils import media

torch.set_num_threads(1)

SIZES = {("LRS2", "pretrain"): 2, ("LRS2", "train"): 2, ("LRS2", "val"): 1,
         ("LRS2", "test"): 2, ("LRS3", "pretrain"): 2,
         ("LRS3", "trainval"): 2, ("LRS3", "test"): 2}
MODES = [("LRS2", "pretrain+train+val"), ("LRS2", "test"),
         ("LRS3", "pretrain+trainval"), ("LRS3", "test")]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("lrs")
    paths = write_lrs_fixture(str(root), seed=5, sizes=SIZES, video=True,
                              seconds=(0.6, 1.2), corpus_lines=300)
    return str(root), paths


def _transforms(side, seed):
    T = jT if side == "jax" else pT
    rng = np.random.RandomState(seed)
    return T.Compose([T.RandomCrop((88, 88), rng=rng),
                      T.RandomHorizontalFlip(rng=rng),
                      T.TimeMaskSecond(T_second=0.4, num_mask_second=1.0,
                                       fps=25.0, mean_frame=True, rng=rng)])


def _same_items(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("version,mode", MODES)
@pytest.mark.parametrize("align", [False, True])
def test_lrs_items_match_jax(tree, version, mode, align):
    root, paths = tree
    kw = dict(batch_size=2, collate_fn=None, version=version, mode=mode,
              root=root, align=align, tokenizer_path=paths["tokenizer"])
    port = plrs.LRS(video_transform=_transforms("port", 3), **kw)
    jax_ = JaxLRS(video_transform=_transforms("jax", 3), **kw)
    assert port.paths == jax_.paths and len(port) == sum(
        n for (v, s), n in SIZES.items() if v == version and s in mode)
    for i in range(len(port)):
        _same_items(port[i], jax_[i])
    assert port.sample_lengths() is None


def test_lrs_audio_only_and_video_only_items(tree):
    root, paths = tree
    for kw in (dict(load_video=False), dict(load_audio=False,
                                            crop_mouth=True)):
        args = dict(batch_size=None, collate_fn=None, version="LRS2",
                    mode="test", root=root, **kw)
        port, jax_ = plrs.LRS(**args), JaxLRS(**args)
        for i in range(len(port)):
            _same_items(port[i], jax_[i])


def test_lrs_filter_cache_and_lengths(tree):
    """The cache file's name and bytes ({paths, lengths} JSON), the lengths
    for the loader's buckets, `ascending`, and an old bare path list."""
    root, _ = tree
    kw = dict(batch_size=2, collate_fn=None, version="LRS3",
              mode="pretrain+trainval", root=root, audio_max_length=16000,
              video_max_length=400, label_max_length=100)
    jax_ = JaxLRS(**kw)
    cache = [f for f in os.listdir(os.path.join(root, "LRS3"))
             if f.endswith("_paths.json")]
    assert len(cache) == 1
    path = os.path.join(root, "LRS3", cache[0])
    with open(path, "rb") as f:
        want = f.read()
    os.remove(path)
    port = plrs.LRS(**kw)
    with open(path, "rb") as f:
        assert f.read() == want
    assert port.paths == jax_.paths and port.sample_lengths() == \
        jax_.sample_lengths() and port.sample_lengths()
    up = plrs.LRS(ascending=True, **kw)
    assert up.sample_lengths() == sorted(port.sample_lengths())
    assert not up.shuffle
    with open(path, "w") as f:
        f.write(str(port.paths).replace("'", '"'))
    old = plrs.LRS(**kw)
    assert old.paths == port.paths and old.sample_lengths() is None
    os.remove(path)


def test_lrs_filter_runs_on_rank_zero_and_is_broadcast(tree, monkeypatch):
    """With a process group of two ranks, rank 1 does not filter: it takes
    rank 0's (paths, lengths) from `broadcast_host_object`."""
    root, _ = tree
    sent = (["a", "b"], [1, 2])
    monkeypatch.setattr(plrs.pdist, "world_size", lambda group=None: 2)
    monkeypatch.setattr(plrs.pdist, "rank", lambda group=None: 1)
    monkeypatch.setattr(plrs.pdist, "broadcast_host_object",
                        lambda obj, root=0, group=None: sent)
    monkeypatch.setattr(plrs.LRS, "filter", lambda self: pytest.fail(
        "rank 1 filtered"))
    ds = plrs.LRS(batch_size=2, collate_fn=None, version="LRS3",
                  mode="test", root=root, audio_max_length=16000)
    assert (ds.paths, ds._lengths) == sent


def test_create_corpus_bytes_match_jax(tree, tmp_path):
    root, _ = tree
    for version, modes in (("LRS2", ["pretrain", "train", "val", "test"]),
                           ("LRS3", ["pretrain", "trainval", "test"])):
        for mode in modes:
            corpus = os.path.join(root, version, f"corpus_{mode}.txt")
            JaxLRS(batch_size=None, collate_fn=None, version=version,
                   mode="test", root=root).create_corpus(mode)
            with open(corpus, "rb") as f:
                want = f.read()
            os.remove(corpus)
            got = plrs.LRS(batch_size=None, collate_fn=None, version=version,
                           mode="test", root=root).create_corpus(mode)
            assert got == corpus
            with open(corpus, "rb") as f:
                assert f.read() == want and want
            os.remove(corpus)


def test_download_raises_naming_credentials_and_files(tree):
    root, _ = tree
    ds = plrs.LRS(batch_size=None, collate_fn=None, version="LRS3",
                  mode="test", root=root)
    with pytest.raises(RuntimeError) as e:
        ds.download()
    msg = str(e.value)
    for word in ("LRS3_USERNAME", "LRS3_PASSWORD", "lrs3_trainval.zip",
                 "lrs3_pretrain_partaa", "LRS3_landmarks.zip",
                 "prepare=True"):
        assert word in msg, word
    ds.version = "LRS2"
    with pytest.raises(RuntimeError, match="LRS2_USERNAME.*lrs2_v1_partaa"):
        ds.download()
    with pytest.raises(RuntimeError, match="downloaded manually"):
        datasets.LRW(batch_size=None, collate_fn=None, root=root,
                     download=True)


def _landmarks(rng, n_frames, h, w):
    """Seeded 68-point landmarks around the frame centre, None on frames 1
    and 2 (interpolated) and on the last (extended)."""
    base = np.stack([rng.uniform(0.35 * w, 0.65 * w, 68),
                     rng.uniform(0.3 * h, 0.7 * h, 68)], 1)
    out = [base + rng.randn(68, 2) for _ in range(n_frames)]
    for i in (1, 2, n_frames - 1):
        out[i] = None
    return out


def _prepare_tree(root, tok, rng):
    """One raw 128 x 128 clip (and wav, transcript) per LRS3 split, with
    its landmark pickle; a seeded mean face."""
    os.makedirs(root)
    mean_face = os.path.join(root, "mean_face.npy")
    np.save(mean_face, np.stack([rng.uniform(80, 176, 68),
                                 rng.uniform(80, 200, 68)], 1))
    for mode in ("pretrain", "trainval", "test"):
        base = os.path.join(root, "LRS3", mode, "00001", "00000")
        os.makedirs(os.path.dirname(base))
        n = int(rng.randint(14000, 18000))
        frames = rng.randint(0, 256, (n // 640 + 1, 128, 128, 3),
                             dtype=np.uint8)
        media.write_video(base + ".mp4", frames, 25.0)
        media.write_audio(base + ".wav",
                          (rng.randn(n) * 0.1).astype(np.float32))
        with open(base + ".txt", "w") as f:
            f.write(f"Text:  HELLO {mode.upper()} WORLD\nConf:  3\n")
        pkl = base.replace(os.path.join(root, "LRS3"), os.path.join(
            root, "LRS3", "LRS3_landmarks")) + ".pkl"
        os.makedirs(os.path.dirname(pkl))
        with open(pkl, "wb") as f:
            pickle.dump(_landmarks(rng, len(frames), 128, 128), f)
    shutil.copy(tok, os.path.join(root, "tok.json"))
    return mean_face


def test_prepare_matches_jax(tree, tmp_path):
    """`prepare` from landmark pickles in two copies of one raw tree, one
    per package: the same files, the same infos (.pt), audio (.flac) and
    corpus bytes, and the same decoded mouth clips (96 x 96)."""
    _, paths = tree
    rng = np.random.RandomState(11)
    src = tmp_path / "src"
    mean_face = _prepare_tree(str(src), paths["tokenizer"], rng)
    roots = {}
    for side, cls in (("jax", JaxLRS), ("port", plrs.LRS)):
        root = str(tmp_path / side)
        shutil.copytree(src, root)
        cls(batch_size=None, collate_fn=None, version="LRS3", mode="test",
            root=root, prepare=True, tokenizer_path=os.path.join(
                root, "tok.json"),
            mean_face_path=mean_face)
        roots[side] = root
    files = {side: sorted(os.path.relpath(os.path.join(d, f), r)
                          for d, _, fs in os.walk(r) for f in fs)
             for side, r in roots.items()}
    assert files["port"] == files["jax"]
    made = [f for f in files["port"] if f.endswith(("_mouth.mp4", ".pt",
                                                    ".flac", ".txt"))]
    assert sum(f.endswith("_mouth.mp4") for f in made) == 3
    for rel in made:
        got, want = (os.path.join(roots[s], rel) for s in ("port", "jax"))
        if rel.endswith(".pt"):
            g, w = (torch.load(p, weights_only=True) for p in (got, want))
            assert set(g) == set(w) and torch.equal(g["label"], w["label"])
            assert all(g[k] == w[k] for k in g if k != "label")
        elif rel.endswith(".mp4"):
            g, w = media.read_video(got)[0], media.read_video(want)[0]
            assert g.shape[1:3] == (96, 96)
            np.testing.assert_array_equal(g, w)
        else:
            assert filecmp.cmp(got, want, shallow=False), rel


def test_lipcrop_functions_match_jax():
    rng = np.random.RandomState(2)
    src, dst = rng.randn(5, 2) * 20 + 50, rng.randn(5, 2) * 20 + 120
    m = plip.umeyama_similarity(src, dst)
    np.testing.assert_array_equal(m, jlip.umeyama_similarity(src, dst))
    pts = rng.randn(68, 2) * 30
    np.testing.assert_array_equal(plip.apply_similarity(m, pts),
                                  jlip.apply_similarity(m, pts))
    frame = rng.randint(0, 256, (120, 100, 3), dtype=np.uint8)
    np.testing.assert_array_equal(plip.warp_frame(frame, m, (256, 256)),
                                  jlip.warp_frame(frame, m, (256, 256)))
    lms = [rng.randn(68, 2) if i not in (0, 3, 4, 7) else None
           for i in range(8)]
    got = plip.landmarks_interpolate(list(lms))
    want = jlip.landmarks_interpolate(list(lms))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert plip.landmarks_interpolate([None, None]) is None
    part = [rng.randn(68, 2) for _ in range(5)]
    np.testing.assert_array_equal(
        np.stack(plip.linear_interpolate(list(part), 0, 4)),
        np.stack(jlip.linear_interpolate(list(part), 0, 4)))
    img = rng.randint(0, 256, (256, 256), dtype=np.uint8)
    for centre in ((128, 128), (20, 30), (250, 240)):
        lm = np.asarray(centre, np.float64) + rng.randn(20, 2)
        np.testing.assert_array_equal(plip.cut_patch(img, lm, 48, 48),
                                      jlip.cut_patch(img, lm, 48, 48))
    lm = np.full((20, 2), -40.0)      # clamped into the image, as the JAX
    np.testing.assert_array_equal(plip.cut_patch(img, lm, 48, 48),
                                  jlip.cut_patch(img, lm, 48, 48))


def test_lipcrop_crop_patch_and_detectors(tmp_path):
    rng = np.random.RandomState(4)
    face = tmp_path / "face.npy"
    np.save(face, np.stack([rng.uniform(80, 176, 68),
                            rng.uniform(80, 200, 68)], 1))
    video = rng.randint(0, 256, (15, 128, 128, 3), dtype=np.uint8)
    lms = plip.landmarks_interpolate(_landmarks(rng, 15, 128, 128))
    got = plip.LipCrop(str(face)).crop_patch(video, lms)
    want = jlip.LipCrop(str(face)).crop_patch(video, lms)
    assert got.shape == (15, 96, 96, 3)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ImportError, match="ibug") as e:
        plip.LipCrop(str(face))(video)
    assert isinstance(e.value, RuntimeError)


def _lrw_tree(root, rng):
    for word in ("ABOUT", "WORLD", "HOUSE"):
        for mode, n in (("train", 2), ("val", 1)):
            d = os.path.join(root, "LRW", "lipread_mp4", word, mode)
            os.makedirs(d)
            for i in range(n):
                frames = rng.randint(0, 256, (29, 110, 110, 3),
                                     dtype=np.uint8)
                media.write_video(os.path.join(d, f"{word}_{i + 1:05d}.mp4"),
                                  frames, 25.0)


def test_lrw_items_and_prepare_match_jax(tmp_path):
    """LRW's class dict, paths and items with seeded transforms after
    `prepare` (without the detectors: each clip resized to 96 x 96) in two
    copies of one tree; the prepared clips decode to the same frames."""
    rng = np.random.RandomState(9)
    src = tmp_path / "src"
    _lrw_tree(str(src), rng)
    face = tmp_path / "face.npy"
    np.save(face, rng.uniform(0, 256, (68, 2)))
    sets = {}
    for side, cls in (("jax", JaxLRW), ("port", datasets.LRW)):
        root = str(tmp_path / side)
        shutil.copytree(src, root)
        sets[side] = [cls(batch_size=2, collate_fn=None, root=root,
                          mode=mode, prepare=(mode == "train"),
                          mean_face_path=str(face),
                          video_transform=_transforms(side, 7))
                      for mode in ("train", "val")]
    for port, jax_ in zip(sets["port"], sets["jax"]):
        assert port.class_dict == jax_.class_dict
        assert [os.path.relpath(p, str(tmp_path / "port"))
                for p in port.paths] == [
            os.path.relpath(p, str(tmp_path / "jax")) for p in jax_.paths]
        for i in range(len(port)):
            (gv, gl), (wv, wl) = port[i], jax_[i]
            assert gv.shape == (29, 88, 88, 1) and gl == wl
            np.testing.assert_array_equal(gv, wv)
