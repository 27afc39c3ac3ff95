"""Build, load and count the hand-written CUDA kernels of `avec_tpu_torch/csrc`.

Each `csrc/*.cu` source has a plain C interface and is compiled on first use
by `nvcc` for `sm_90a` into its own shared library under
`build/avec_tpu_torch/<hash of the sources>/`, loaded with `ctypes`. All
sources are compiled in parallel, one `nvcc` each. A missing `nvcc` or a
failed build raises: no wrapper falls back to the plain version for a CUDA
tensor.

`launches` counts kernel launches by wrapper name; each wrapper adds one where
it launches its kernel and nowhere else.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "avec_tpu_torch"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "ffn.cu",
           "stem.cu", "attention_module.cu", "conv_module.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = collections.Counter()
build_log = {}  # source -> nvcc output (ptxas register/shared-memory report)
_libs = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of avec_tpu_torch "
                       "are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile (once, in parallel) and load every kernel library."""
    with _lock:
        if _libs:
            return _libs
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        jobs = []
        for src in SOURCES:
            so = out_dir / (Path(src).stem + ".so")
            if so.is_file():
                continue
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            jobs.append((src, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, so, tmp, proc in jobs:
            out, _ = proc.communicate()
            build_log[src] = out
            if proc.returncode:
                failed.append(f"{src}:\n{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for src in SOURCES:
            _libs[Path(src).stem] = ctypes.CDLL(
                str(out_dir / (Path(src).stem + ".so")))
        return _libs


def library(name: str) -> ctypes.CDLL:
    return build()[name]


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
