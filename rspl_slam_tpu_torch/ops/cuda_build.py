"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Libraries land in
``rspl_slam_tpu_torch/_build/`` (git-ignored), keyed by a hash of the
sources and flags, at first use. :func:`build_all` starts one ``nvcc`` per
source at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["SOURCES", "build_all", "library", "launch", "stream_of"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("conv_stem", "superglue_layer", "sinkhorn")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 CTA may use
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", ARCH]

# C signatures: "p" = pointer / stream (c_void_p), "i" = c_int
SIGNATURES = {
    "conv_stem": {"conv_stem_launch": "pppppp" + "iii" + "p"},
    "superglue_layer": {"superglue_layer_launch": "p" * 15 + "iii" + "p",
                        "superglue_layer_bf16_launch": "p" * 14 + "iii" + "p"},
    "sinkhorn": {"sinkhorn_launch": "pppp" + "iiii" + "iii" + "p"},
}
_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# the wrappers' launch counters are read-modify-writes from every thread
# that launches (PipelinedRunner's extract and tracking threads)
count_lock = threading.Lock()
build_log: dict[str, str] = {}  # name -> nvcc output (incl. -Xptxas -v)


def _nvcc() -> str:
    cand = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cand.append(os.path.join(os.environ[env], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cand.append(shutil.which("nvcc"))
    cand.append("/usr/local/cuda/bin/nvcc")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, f"-I{CSRC}", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every kernel library not yet built, one ``nvcc`` per source
    running in parallel. Returns the wall time (s) and per-library logs
    land in :data:`build_log`."""
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            _finish(n, s)
    return {"build_s": time.perf_counter() - t0}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        for fn, sig in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = [_CTYPE[c] for c in sig], ctypes.c_int
        _libs[name] = lib
    return lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, fn: str, *args) -> None:
    """Call ``fn`` of library ``name`` with its declared signature: tensors
    pass as their data pointers, None as a null pointer. The caller keeps
    every tensor alive across the call. Raises on a non-zero CUDA error
    code (a refused launch never runs, and a later synchronize would not
    report it)."""
    lib = library(name)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(lib, fn)(*cargs)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}.{fn} failed: CUDA error {err} ({msg})")


def require_cuda(t: torch.Tensor, what: str, dtype: torch.dtype, shape=None):
    """Check a kernel argument: CUDA device, dtype, contiguity, shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
