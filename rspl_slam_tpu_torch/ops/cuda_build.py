"""Build and load the port's hand-written CUDA kernels and its host C++.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Libraries land in
``rspl_slam_tpu_torch/_build/`` (git-ignored), keyed by a hash of the
sources and flags, at first use. :func:`build_all` starts one compiler per
source at once. Nothing here runs at import time.

``png_unfilter`` is host code only (the PNG reader's row unfilter,
``png.unfilter_compiled``): it rides the same build and ``ctypes``
interface but is no kernel and replaces no TPU kernel.

``HOST_SOURCES`` (``csrc/<name>.cpp``, the native runtime of ``native.py``,
with the ``csrc/*.h`` headers it includes: the TIFF, BMP and PIL-model
decoders) have no device code and build with the host C++ compiler
(``$CXX``, else ``c++``, else ``g++``), linking nothing but ``-pthread``, so
they build wherever the CPU tests run. Their hash also covers the headers,
the compiler and its version: a library built on one machine is not loaded
on another.
``-ffp-contract=off`` keeps every product and sum rounded on its own, so
results do not depend on the host's FMA units.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["KERNELS", "SOURCES", "build_all", "library", "launch", "stream_of",
           "launch_counts", "refuse_grad"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
KERNELS = ("conv_stem", "superglue_layer", "sinkhorn")
HOST_SOURCES = ("native_runtime",)
SOURCES = KERNELS + ("png_unfilter",) + HOST_SOURCES
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 CTA may use
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", ARCH]
HOST_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-pthread", "-ffp-contract=off"]

# C signatures: "p" = pointer / stream (c_void_p), "i" = c_int
SIGNATURES = {
    "conv_stem": {"conv_stem_launch": "pppppp" + "iii" + "p"},
    "superglue_layer": {"superglue_layer_launch": "p" * 14 + "iii" + "p",
                        "superglue_layer_bf16_launch": "p" * 14 + "iiii" + "p",
                        "superglue_layer_two_set_launch": "p" * 16 + "iii" + "p",
                        "superglue_layer_two_set_bf16_launch": "p" * 16 + "iiii" + "p"},
    "sinkhorn": {"sinkhorn_launch": "pppp" + "iiii" + "iii" + "p",
                 "sinkhorn_global_clusters": "p",
                 "sinkhorn_global_launch": "pppppp" + "i" * 9 + "p"},
    "png_unfilter": {"png_unfilter": "pp" + "iii"},
    "native_runtime": {"native_merge_lines": "pi" + "ddd" + "p",
                       "native_remap_bilinear": "pii" + "pp",
                       "native_decode_u8": "plp" + "ii",
                       "native_image_size": "plp",
                       "native_identify": "plp",
                       "native_png_layout": "plpl",
                       "native_png_tail": "pll",
                       "native_decode_file": "sp" + "ii",
                       "native_loader_create": "ppiiippiip",
                       "native_loader_next": "ppp",
                       "native_loader_destroy": "p",
                       "native_runtime_error_kind": "i"},
}
# "p" pointer / stream, "i" int, "l" int64, "d" double, "s" C string (bytes)
_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_int64,
          "d": ctypes.c_double, "s": ctypes.c_char_p}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# the wrappers' launch counters are read-modify-writes from every thread
# that launches (PipelinedRunner's extract and tracking threads)
count_lock = threading.Lock()
build_log: dict[str, str] = {}  # name -> compiler output (nvcc's incl. -Xptxas -v)
build_seconds: dict[str, float] = {}  # name -> wall time of its compiler process


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


def _cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++``, else ``g++``."""
    for c in (os.environ.get("CXX"), "c++", "g++"):
        path = c and shutil.which(c)
        if path:
            return path
    raise RuntimeError("no host C++ compiler found: set CXX (or install c++/g++)")


@functools.lru_cache(maxsize=None)
def _compiler_id(cxx: str) -> bytes:
    return cxx.encode() + subprocess.run([cxx, "--version"], capture_output=True,
                                         check=True).stdout


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _command(name: str, out: Path) -> list[str]:
    if name in HOST_SOURCES:
        return [_cxx(), *HOST_FLAGS, "-o", str(out), str(_source(name))]
    return [_nvcc(), *FLAGS, f"-I{CSRC}", "-o", str(out), str(_source(name))]


def _target(name: str) -> Path:
    h = hashlib.sha256()
    if name in HOST_SOURCES:
        for p in sorted(CSRC.glob("*.h")) + [_source(name)]:
            h.update(p.read_bytes())
        h.update(" ".join(HOST_FLAGS).encode())
        h.update(_compiler_id(_cxx()))
    else:
        for p in sorted(CSRC.glob("*.cuh")) + [_source(name)]:
            h.update(p.read_bytes())
        h.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(proc.args[0]).name} failed for "
                           f"csrc/{_source(name).name}:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builds each rename a whole library


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every library not yet built, one compiler per source running
    in parallel. Returns the wall time (s); each library's own compile time
    lands in :data:`build_seconds` and its log in :data:`build_log`."""
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in names}
        errors = []

        def finish(n):
            try:
                _finish(n, started[n])
            except RuntimeError as e:
                errors.append(e)

        waiters = [threading.Thread(target=finish, args=(n,)) for n in started]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        if errors:
            raise errors[0]
    return {"build_s": time.perf_counter() - t0}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use; a failed build
    raises)."""
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


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would need a kernel's backward: grad mode on and
    any of ``tensors`` requiring grad. The kernels are inference-only, as
    the Pallas kernels they replace have no VJP; a kernel's output would
    carry no ``grad_fn`` and a training step would drop the gradient
    silently. Trainers run their own plain forwards (``training/``)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward; call it under "
                           "torch.no_grad() or on tensors that do not require grad")


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launch counter (K1 and K2 per mode, K2's
    two-set variant per mode, K2's streamed bf16 kernel, K3's cluster and
    global-memory kernels): a wrapper adds one where it launches its
    kernel and nowhere else."""
    from rspl_slam_tpu_torch.ops import attention_cuda, conv_stem_cuda, sinkhorn_cuda

    return {"conv_stem": conv_stem_cuda.launches,
            "conv_stem_side": conv_stem_cuda.side_launches,
            "superglue_layer": attention_cuda.launches,
            "superglue_layer_f32": attention_cuda.f32_launches,
            "superglue_layer_two_set": attention_cuda.two_set_launches,
            "superglue_layer_two_set_f32": attention_cuda.two_set_f32_launches,
            "superglue_layer_streamed": attention_cuda.streamed_launches,
            "sinkhorn": sinkhorn_cuda.launches,
            "sinkhorn_global": sinkhorn_cuda.global_launches}
