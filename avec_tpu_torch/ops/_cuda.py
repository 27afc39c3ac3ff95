"""Build, load and count the hand-written CUDA kernels of `avec_tpu_torch/csrc`.

Each `csrc/*.cu` source has a plain C interface and is compiled on first use
by `nvcc` for `sm_90a` into its own shared library under
`build/avec_tpu_torch/<hash of the sources>/`, loaded with `ctypes`. All
sources are compiled in parallel, one `nvcc` each. A missing `nvcc` or a
failed build raises: no wrapper falls back to the plain version for a CUDA
tensor. `control_library` builds one source with a define into a library
of its own, for measurements that hold a kernel against a variant of it.

`launches` counts kernel launches by wrapper name. Each wrapper makes its C
call inside `launch(name, ...)`, which counts one under each name once the
call has passed `check`, and spans it as `avec/kernel/<name>` while a
profiler records (`utils/spans.py`).
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

from avec_tpu_torch.utils import spans

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "avec_tpu_torch"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "ffn.cu",
           "stem.cu", "attention_module.cu", "conv_module.cu", "batch_norm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = collections.Counter()
build_log = {}  # source [defines] -> nvcc output (ptxas registers, shared memory)
_libs = {}
_controls = {}  # control builds by source and define
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


def _compile(jobs) -> None:
    """Wait for the nvcc `jobs` (log key, library, temporary file, process)
    and move each library into place; raise if any build failed."""
    failed = []
    for key, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        build_log[key] = out
        if proc.returncode:
            failed.append(f"{key}:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def _start(src: str, so: Path, defines=()):
    """Start nvcc on `src` with `defines`; the job for `_compile`, its log
    keyed by the source and its defines."""
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    flags = [f"-D{d}" for d in defines]
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC / src)]
    return " ".join([src, *flags]), so, tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build() -> dict:
    """Compile (once, in parallel) and load every kernel library."""
    with _lock:
        if _libs:
            return _libs
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        _compile([_start(src, out_dir / (Path(src).stem + ".so"))
                  for src in SOURCES
                  if not (out_dir / (Path(src).stem + ".so")).is_file()])
        for src in SOURCES:
            _libs[Path(src).stem] = ctypes.CDLL(
                str(out_dir / (Path(src).stem + ".so")))
        return _libs


def control_library(name: str, define: str) -> ctypes.CDLL:
    """The source `name` built with `-D<define>` into a library of its own
    (once): a control build that measurements hold the kernel against. No
    wrapper loads it."""
    with _lock:
        key = f"{name}-{define}"
        if key not in _controls:
            out_dir = BUILD_ROOT / _digest()
            out_dir.mkdir(parents=True, exist_ok=True)
            so = out_dir / (key.replace("=", "_") + ".so")
            if not so.is_file():
                _compile([_start(name + ".cu", so, (define,))])
            _controls[key] = ctypes.CDLL(str(so))
        return _controls[key]


def library(name: str) -> ctypes.CDLL:
    return build()[name]


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


class launch:
    """`with launch(*names): rc = <C call>; check(rc, names[0])`: the call
    under the span `avec/kernel/<names[0]>`, then one launch counted under
    each name where the block raised nothing."""

    __slots__ = ("names", "span")

    def __init__(self, *names: str):
        self.names = names
        self.span = spans.span(spans.KERNEL + names[0])

    def __enter__(self):
        self.span.__enter__()

    def __exit__(self, kind, value, tb):
        self.span.__exit__(kind, value, tb)
        if kind is None:
            for name in self.names:
                launches[name] += 1


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's device (without building
    a `torch.cuda.Stream`, which costs more host time than a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
