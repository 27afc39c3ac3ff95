"""ctypes bindings of the native C++ beam decoder (port of
avec_tpu/decode/native.py:30-139; source `avec_tpu_torch/csrc/
beam_decoder.cpp`).

The shared library is built on first use with `g++ -O3 -std=c++17 -shared
-fPIC` into `build/avec_tpu_torch/<hash of the source and flags>/`, as
`ops/_cuda.py` builds the kernels: each process compiles into a file of its
own and moves it into place with an atomic rename, so processes that build
at once (test workers) never load half a file. A missing compiler or a
failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "beam_decoder.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "avec_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

Beams = List[Tuple[Tuple[int, ...], float]]

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libbeamdecoder.so"


def build_library() -> Path:
    """Compile the decoder library once (idempotent); returns its path."""
    so = library_path()
    if so.is_file():
        return so
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: the native beam "
                           "decoder is built from source at first use")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        c_int = ctypes.c_int
        lib.bd_create.restype = ctypes.c_void_p
        lib.bd_create.argtypes = [c_int, c_int, ctypes.c_double,
                                  ctypes.c_double, ctypes.c_char_p, c_int]
        lib.bd_destroy.argtypes = [ctypes.c_void_p]
        lib.bd_set_cutoff.argtypes = [ctypes.c_void_p, c_int, ctypes.c_double]
        lib.bd_decode.restype = c_int
        lib.bd_decode.argtypes = [ctypes.c_void_p, f32, c_int, c_int, c_int,
                                  i32, i32, f64, c_int]
        lib.bd_decode_batch.argtypes = [ctypes.c_void_p, f32, c_int, c_int,
                                        c_int, i32, i32, i32, f64, c_int,
                                        c_int]
        _lib = lib
        return lib


class NativeBeamDecoder:
    """The C++ prefix beam search, with the contract of
    `decode.beam.ctc_prefix_beam_search`: (prefix, combined log-likelihood)
    pairs, best first."""

    def __init__(self, blank: int = 0, beam_size: int = 16, alpha: float = 0.6,
                 beta: float = 1.0, ngram_path: Optional[str] = None,
                 ngram_offset: int = 100, cutoff_top_n: Optional[int] = None,
                 num_threads: int = 8):
        self._lib = _load()
        path = (ngram_path or "").encode()
        self._handle = self._lib.bd_create(blank, beam_size, alpha, beta,
                                           path, ngram_offset)
        if not self._handle:
            raise RuntimeError(f"bd_create failed (ngram_path={ngram_path})")
        if cutoff_top_n is not None:
            # each frame's top n tokens and the blank (no cumulative-prob cut)
            self._lib.bd_set_cutoff(self._handle, int(cutoff_top_n), 1.0)
        self.beam_size = beam_size
        self.num_threads = num_threads

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bd_destroy(self._handle)
            self._handle = None

    def decode(self, logp: np.ndarray, seq_len: int,
               max_out_len: int = 512) -> Beams:
        """One utterance's (T, V) log-probs over its first seq_len frames."""
        logp = np.ascontiguousarray(logp, dtype=np.float32)
        t, v = logp.shape
        tokens = np.zeros((self.beam_size, max_out_len), np.int32)
        lens = np.zeros((self.beam_size,), np.int32)
        scores = np.zeros((self.beam_size,), np.float64)
        n = self._lib.bd_decode(self._handle, logp, t, v, int(seq_len),
                                tokens, lens, scores, max_out_len)
        return [(tuple(tokens[i, :lens[i]].tolist()), float(scores[i]))
                for i in range(n)]

    def decode_batch(self, logp: np.ndarray, seq_lens: np.ndarray,
                     max_out_len: int = 512) -> List[Beams]:
        """A (B, T, V) batch on the C++ thread pool of `num_threads`
        threads; per utterance, the beams of `decode`."""
        logp = np.ascontiguousarray(logp, dtype=np.float32)
        b, t, v = logp.shape
        seq_lens = np.ascontiguousarray(seq_lens, dtype=np.int32)
        tokens = np.zeros((b, self.beam_size, max_out_len), np.int32)
        lens = np.zeros((b, self.beam_size), np.int32)
        scores = np.full((b, self.beam_size), -np.inf, np.float64)
        self._lib.bd_decode_batch(self._handle, logp, b, t, v, seq_lens,
                                  tokens, lens, scores, max_out_len,
                                  int(self.num_threads))
        return [[(tuple(tokens[i, k, :lens[i, k]].tolist()),
                  float(scores[i, k]))
                 for k in range(self.beam_size)
                 if np.isfinite(scores[i, k]) or lens[i, k] > 0]
                for i in range(b)]
