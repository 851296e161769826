"""Build, load and count the hand-written CUDA kernels.

At first use every ``csrc/*.cu`` source is compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together) and linked into
one shared library with a plain C interface, loaded with ``ctypes``.  The
library lives under ``_build/<hash of the sources and flags>/`` inside the
package, so an edited source rebuilds and an unchanged one loads at once.

Nothing here runs at import: the CPU tests import every module, on
machines that may have no ``nvcc`` and no card.

``LAUNCHES`` counts kernel launches per wrapper.  A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its path
went through the kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
#: q, k, v, o, B, Sq, Skv, Kh, G, hd, causal, window, softcap, scale, stream
_FLASH = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P)
#: C entry points and their argument types (every pointer and the stream as
#: c_void_p; each returns a cudaError_t code).  They launch on the calling
#: thread's current device, which the wrappers set with
#: ``torch.cuda.device`` for the call only.
_SIGNATURES = {
    #: table, n_keys, size, max_probes, n, 4 key columns, idx, found,
    #: stream
    "repro_hash_probe": (_P, _I, _I64, _I, _I64, _P, _P, _P, _P, _P, _P, _P),
    #: ids, values, values' row stride, n, C, n_groups, rows_per_block,
    #: n_slices, int and float workspace, sums, sums' row stride, counts
    #: (radix groupby only), stream
    "repro_radix_groupby": (_P, _P, _I64, _I64, _I, _I, _I64, _I, _P, _P, _P,
                            _I64, _P, _P),
    "repro_segment_sum": (_P, _P, _I64, _I64, _I, _I, _I64, _I, _P, _P, _P,
                          _I64, _P),
    "repro_flash_attention_fp32": _FLASH,
    "repro_flash_attention_bf16": _FLASH,
    "repro_mamba_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build printed (nvcc -Xptxas -v) and how long it took
build_log = ""
build_seconds = 0.0

LAUNCHES: Dict[str, int] = {"hash_probe": 0, "radix_groupby": 0,
                            "segment_sum": 0, "flash_attention": 0,
                            "mamba_scan": 0}
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    """Compile (or find) the library for the current sources."""
    global build_log, build_seconds
    cu = sorted(CSRC.glob("*.cu"))
    key = _source_hash(cu + sorted(CSRC.glob("*.cuh")))
    out_dir = BUILD_ROOT / key
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    t0 = time.perf_counter()
    work = out_dir / f"tmp-{os.getpid()}-{threading.get_ident()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in cu:
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
               str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = []
    failed = []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"--- {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp_lib = work / LIB_NAME
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp_lib),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp_lib, lib)           # atomic: a reader never sees a half
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(_build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
                lib.repro_cuda_error_string.restype = ctypes.c_char_p
                _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as an integer handle (the raw
    call: building a ``torch.cuda.Stream`` costs microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def device_guard(t: torch.Tensor):
    """Make ``t``'s device current for a launch (the entry points launch on
    the calling thread's current device); no guard when it already is."""
    idx = t.get_device()
    if idx == torch._C._cuda_getDevice():
        return contextlib.nullcontext()
    return torch.cuda.device(idx)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: Optional[torch.device] = None) -> None:
    """Check what a kernel takes: a contiguous CUDA tensor of ``dtype``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
