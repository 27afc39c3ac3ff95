"""The port's serving front end: requests from wav / flac files, the
submit / finish pipeline, the stdin loop, `stream_file` and `main()`.

The three cases of tests/test_serve.py run on the port (bucketing,
cross-request batching with error rows, the stdin loop), at a small AO
depth (blocks (2, 2, 1), vocab 32, fp32 on the CPU, seeded weights, a head
whose argmax lands on real pieces); then what tools/serve.py adds: results
from files equal to results from the same arrays, the one-deep pipeline's
order, `stream_file`'s JSON lines for the bidirectional and the causal
model, and `main()`'s argument errors and a run on the CPU.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from avec_tpu_torch import serve
from avec_tpu_torch.models.zoo import (AudioEfficientConformerInterCTC,
                                       randomize_batch_stats)
from avec_tpu_torch.serve import Server, stdin_loop, stream_file
from avec_tpu_torch.utils import media
from avec_tpu_torch.utils.tokenizer import Tokenizer, train_bpe

torch.set_num_threads(1)

SMALL = dict(vocab_size=32, num_blocks=(2, 2, 1), interctc_blocks=())


def _write_wav(path, seconds, freq=440.0):
    """Tones changing pitch and loudness every 0.12 s."""
    n, seg = int(16000 * seconds), 1920
    rng = np.random.RandomState(int(freq))
    f = np.repeat(rng.uniform(100, 4000, n // seg + 1), seg)[:n]
    amp = np.repeat(rng.uniform(0.05, 0.5, n // seg + 1), seg)[:n]
    media.write_audio(str(path), (amp * np.sin(2 * np.pi * np.cumsum(f)
                                               / 16000)).astype(np.float32),
                      16000)
    return str(path)


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "tok.json")
    Tokenizer(train_bpe(["hello world serving test"] * 4,
                        vocab_size=32)).save(path)
    return path


def _model(causal=False, seed=0):
    kw = dict(causal=True, left_context=32) if causal else dict(use_flash=True)
    model = AudioEfficientConformerInterCTC(
        device="cpu", generator=torch.Generator().manual_seed(seed), **SMALL,
        **kw)
    with torch.no_grad():
        randomize_batch_stats(model, torch.Generator().manual_seed(seed + 1))
        bias = torch.full((32,), -20.0)
        bias[1:12] = torch.randn(11, generator=torch.Generator()
                                 .manual_seed(seed + 2)) * 2
        model.encoder.head.bias.copy_(bias)
    return model


def _server(tok, **kw):
    return Server(model=_model(kw.pop("causal", False)), mode="ao",
                  device="cpu", precision="float32", tokenizer=tok, **kw)


def test_serve_ao_bucketed(tmp_path, tok):
    """tests/test_serve.py::test_serve_ao_bucketed_compile_cache on the
    port: requests in one length bucket add no shape, a longer one adds
    one; results are JSON; the same audio in a bucket twice as long
    decodes identically."""
    srv = _server(tok)
    w1 = _write_wav(tmp_path / "a.wav", 0.20)
    w2 = _write_wav(tmp_path / "b.wav", 0.23, freq=220.0)
    w3 = _write_wav(tmp_path / "c.wav", 0.60)
    r1, r2, r3 = (srv.transcribe(w) for w in (w1, w2, w3))
    assert [r["compiled_buckets"] for r in (r1, r2, r3)] == [1, 1, 2]
    for r, w in zip((r1, r2, r3), (w1, w2, w3)):
        assert r["file"] == w and isinstance(r["text"], str)
        assert r["rtf"] > 0 and "tokens" not in r
        json.dumps(r)
    assert r3["text"]
    audio, _ = media.read_audio(w1)
    req = {"audio": audio}
    texts = []
    for bucket in (serve._bucket(len(audio)), serve._bucket(len(audio)) * 2):
        out = srv.forward(srv._inputs_for_batch([req], bucket, 1))
        texts.append(srv.decoder(srv.decoder.device_fn(out))[0])
    assert texts[0] == texts[1] == r1["text"]


def test_serve_cross_request_batching(tmp_path, tok):
    """tests/test_serve.py::test_serve_cross_request_batching on the port:
    3 requests as one batch (bucket 4) decode as each alone; a missing path
    becomes an {"file", "error"} row and the rest still run; stats."""
    srv = _server(tok)
    paths = [_write_wav(tmp_path / f"q{i}.wav", sec, freq)
             for i, (sec, freq) in enumerate([(0.20, 440.0), (0.23, 220.0),
                                              (0.15, 660.0)])]
    singles = [srv.transcribe(p) for p in paths]
    batched = srv.transcribe_batch(paths)
    assert [r["text"] for r in batched] == [r["text"] for r in singles]
    assert any(r["text"] for r in singles)
    assert all(r["batch_size"] == 3 and r["latency_s"] > 0 for r in batched)
    missing = str(tmp_path / "missing.wav")
    mixed = srv.transcribe_batch([paths[0], missing])
    assert mixed[0]["text"] == singles[0]["text"]
    assert mixed[0]["batch_size"] == 1
    assert set(mixed[1]) == {"file", "error"} and mixed[1]["file"] == missing
    s = srv.stats_summary()
    assert s["requests"] == len(srv.latencies) == 7
    assert s["latency_p95_s"] >= s["latency_p50_s"] > 0 and s["rtf_mean"] > 0


def test_error_rows_keep_the_batch(tmp_path, tok):
    """A file that is no audio, a video path (mode "ao" needs audio: no
    .wav beside it, or no OpenCV), a dict without "audio" and a missing
    path each give an error row; the good request's result is that of
    serving it alone."""
    srv = _server(tok)
    good = _write_wav(tmp_path / "g.wav", 0.3)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file")
    items = [str(bad), good, str(tmp_path / "clip.mp4"),
             {"video": np.zeros((3, 88, 88, 1), np.float32)},
             str(tmp_path / "gone.flac")]
    rows = srv.transcribe_batch(items)
    assert rows[1]["text"] == srv.transcribe(good)["text"]
    assert rows[1]["batch_size"] == 1
    for i in (0, 2, 4):
        assert set(rows[i]) == {"file", "error"} and rows[i]["file"] == items[i]
    assert set(rows[3]) == {"error"} and "audio" in rows[3]["error"]
    assert srv.transcribe_batch([str(bad)]) == [
        {"file": str(bad), "error": rows[0]["error"]}]


def test_files_equal_arrays(tmp_path, tok):
    """wav and flac files of the same samples and the samples as arrays:
    identical texts (flac is lossless); without a tokenizer the same
    requests give token ids."""
    srv = _server(tok)
    rng = np.random.RandomState(0)
    paths, arrays = [], []
    for i, sec in enumerate((0.4, 1.1, 0.7)):
        wav = _write_wav(tmp_path / f"r{i}.wav", sec, 300.0 + 100 * i)
        audio, _ = media.read_audio(wav)
        flac = str(tmp_path / f"r{i}.flac")
        media.write_audio(flac, audio, 16000)
        paths += [wav, flac]
        arrays += [{"audio": audio}] * 2
    from_files = srv.transcribe_batch(paths)
    from_arrays = srv.transcribe_batch(arrays)
    texts = [r["text"] for r in from_files]
    assert texts == [r["text"] for r in from_arrays]
    assert texts[0::2] == texts[1::2] and any(texts)
    assert all("file" not in r for r in from_arrays)
    ids = Server(model=srv.model, mode="ao", device="cpu",
                 precision="float32").transcribe_batch(paths)
    assert all(r["text"] is None and isinstance(r["tokens"], list)
               for r in ids)
    assert ids[0]["tokens"] == ids[1]["tokens"] and any(
        r["tokens"] for r in ids)


def test_serve_stdin_batching_loop(tmp_path, tok):
    """tests/test_serve.py::test_serve_stdin_batching_loop on the port:
    three queued lines, one JSON line each, gathered into one batch."""
    srv = _server(tok)
    w = _write_wav(tmp_path / "s.wav", 0.2)
    out = io.StringIO()
    stdin_loop(srv, max_batch=4, window_ms=200.0, out=out,
               stream=io.StringIO(f"{w}\n{w}\n{w}\n"))
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(lines) == 3
    assert all(isinstance(r["text"], str) and r["file"] == w for r in lines)
    assert max(r["batch_size"] for r in lines) >= 2


def test_stdin_loop_pipelines_one_batch_deep(tmp_path, tok):
    """8 queued paths (one missing), max_batch 4: batch 2 is submitted
    before batch 1 is finished; the results, in input order, equal
    transcribe_batch's of the same paths."""
    srv = _server(tok)
    paths = [_write_wav(tmp_path / f"p{i}.wav", 0.2 + 0.1 * i, 200.0 + 50 * i)
             for i in range(7)]
    paths.insert(5, str(tmp_path / "missing.wav"))
    calls = []
    submit, finish = srv.submit_batch, srv.finish_batch

    def rec_submit(items, times=None):
        calls.append(("submit", len(items)))
        return submit(items, times)

    def rec_finish(pending):
        calls.append(("finish", len(pending["items"])))
        return finish(pending)

    srv.submit_batch, srv.finish_batch = rec_submit, rec_finish
    out = io.StringIO()
    stdin_loop(srv, max_batch=4, window_ms=500.0, out=out,
               stream=io.StringIO("".join(p + "\n" for p in paths)))
    assert calls == [("submit", 4), ("submit", 4), ("finish", 4),
                     ("finish", 4)]
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    srv.submit_batch, srv.finish_batch = submit, finish
    want = srv.transcribe_batch(paths[:4]) + srv.transcribe_batch(paths[4:])
    assert [r.get("file") for r in lines] == paths
    assert [r.get("text") for r in lines] == [r.get("text") for r in want]
    assert "error" in lines[5]


@pytest.mark.parametrize("causal", [False, True])
def test_stream_file_json_lines(tmp_path, tok, causal):
    """stream_file: one partial line per changed partial ("file",
    "partial", "t"), then the final line ("text", "final", "device_seconds");
    the bidirectional final is the offline greedy text of the whole file,
    the causal one the offline causal forward's; every causal partial a
    prefix of the final."""
    srv = _server(tok, causal=causal)
    assert srv.causal is causal
    w = _write_wav(tmp_path / "long.wav", 2.3)
    out = io.StringIO()
    final = stream_file(srv, w, chunk_ms=240.0, out=out)
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert lines[-1] == {"file": w, "text": final["text"], "final": True,
                         "device_seconds": round(final["device_seconds"], 4)}
    partials = lines[:-1]
    assert partials and all(set(p) == {"file", "partial", "t"}
                            for p in partials)
    assert [p["t"] for p in partials] == sorted(p["t"] for p in partials)
    audio, _ = media.read_audio(w)
    if causal:
        offline = srv.transcribe_batch([{"audio": audio}])[0]["text"]
        assert all(final["text"].startswith(p["partial"]) for p in partials)
    else:
        bucket = serve._bucket(len(audio))
        out_ = srv.forward(srv._inputs_for_batch([{"audio": audio}], bucket,
                                                 1))
        offline = srv.decoder(srv.decoder.device_fn(out_))[0]
    assert final["text"] == offline and offline


@pytest.mark.parametrize("argv,message", [
    (["--stream", "--mode", "av", "a.wav"], "--stream is audio-only"),
    (["--stream"], "--stream requires at least one wav path"),
    (["--ngram", "lm.arpa", "a.wav"], "--ngram/--neural_config require"),
    (["--neural_config", "cfg", "a.wav"], "--ngram/--neural_config require"),
    (["--causal", "--mode", "vo", "a.wav"], "--causal is audio-only"),
    (["--decoder", "beam", "--tokenizer", "missing.json", "a.wav"],
     "--decoder beam needs a tokenizer"),
    (["--mode", "xx"], "invalid choice"),
])
def test_main_argument_errors(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_server_refuses_bad_options(tmp_path, tok):
    with pytest.raises(ValueError, match="causal"):
        Server(mode="vo", device="cpu", causal=True)
    with pytest.raises(FileNotFoundError):
        Server(model=_model(), mode="ao", device="cpu",
               checkpoint=str(tmp_path / "none.ckpt"))
    with pytest.raises(FileNotFoundError):
        Server(model=_model(), mode="ao", device="cpu", decoder="beam")
    with pytest.raises(ValueError, match="greedy"):
        Server(model=_model(), mode="ao", device="cpu", decoder="viterbi")


def test_main_serves_files_and_stdin_on_cpu(tmp_path, tok, capsys,
                                            monkeypatch):
    """`python -m avec_tpu_torch.serve` on the CPU at the reference AO
    depth with a checkpoint of seeded weights: a JSON line per file, then
    the stdin loop's lines, and the summary on stderr; the texts are the
    checkpoint's (a server built on the same weights gives them)."""
    from avec_tpu_torch.train.checkpoint import save_checkpoint

    model = AudioEfficientConformerInterCTC(
        device="cpu", interctc_blocks=(), use_flash=True,
        generator=torch.Generator().manual_seed(5))
    ckpt = str(tmp_path / "ao.ckpt")
    save_checkpoint(ckpt, model.state_dict())
    paths = [_write_wav(tmp_path / "m0.wav", 0.3),
             _write_wav(tmp_path / "m1.wav", 0.5, 880.0)]
    monkeypatch.setattr("sys.stdin", io.StringIO(paths[1] + "\n"))
    serve.main(["--device", "cpu", "--tokenizer", tok, "--checkpoint", ckpt,
                "--stdin", "--batch_window_ms", "10"] + paths)
    captured = capsys.readouterr()
    lines = [json.loads(line) for line in captured.out.splitlines()]
    assert [r["file"] for r in lines] == paths + paths[1:]
    want = Server(model=model, mode="ao", device="cpu", tokenizer=tok)
    texts = [r["text"] for r in want.transcribe_batch(paths)]
    assert [r["text"] for r in lines] == texts + texts[1:]
    summary = json.loads(captured.err.strip().splitlines()[-1])["summary"]
    assert summary["requests"] == 3
    assert "WARNING" not in captured.err
    os.remove(ckpt)
