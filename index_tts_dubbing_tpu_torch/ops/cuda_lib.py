"""Build and load the port's CUDA kernels (``csrc/*.cu``) as one shared
library with a plain C interface, bound with ``ctypes``.

One ``nvcc`` per source, all started together, compiles every source for
``sm_90a``; one more links the objects into
``_build/libkernels_<hash>.so``, where the hash covers the sources and the
flags, so an edited source never loads a stale library. The linker writes
to a temporary name that ``os.replace`` then moves into place: a build that
is cut off leaves no half-written library and no lock. The first call
builds; later calls in the process reuse the loaded library.

Nothing here runs at import: the CPU tests import every module, and this
machine may have neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
NVCC_TIMEOUT_S = 300

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points: argument types, in order (each returns cudaGetLastError()).
SIGNATURES = {
    # x, out, alpha, beta, param dtype, logscale, host taps, rows, C, T,
    # run, vec, lanes, passes, chunk, exact edge, dtype, stream
    "snake_cmajor": [_P, _P, _P, _P, _I, _I, _P] + [_I] * 10 + [_P],
    # x, out, alpha, beta, param dtype, logscale, host taps, B, T, C, vec,
    # run, runs, threads, dtype, stream
    "snake_clast": [_P, _P, _P, _P, _I, _I, _P] + [_I] * 8 + [_P],
    # dtype, vec, &threads_per_sm (int)
    "snake_cmajor_resident": [_I, _I, _P],
    "snake_clast_resident": [_I, _I, _P],
    # x, out, w1, b1, w2, b2, acts, filt, scratch, B, C, Cp, T, k, d0, d1,
    # d2, tt, cpad, exact edge, dtype, stream
    "resblock_cmajor": [_P] * 9 + [_I] * 12 + [_P],
    # k, v, cp, L, BN, H, slab_elems, copy_elems, esize, stream
    "copy_on_fork": [_P, _P, _P, _I, _I, _I, _L, _L, _I, _P],
    # k_in, v_in, k_out, v_out, src, L, BN, H, slab_elems, live_elems, esize,
    # stream
    "permute_gen_cache": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _P],
    # qkv, kp, vp, kg, vg, keep, amap, slot, out, qkv row stride, B, H, nb,
    # S0, G, D, split, dtype, stream
    "anc_attention": [_P] * 9 + [_L] + [_I] * 8 + [_P],
    # dtype, D, &threads_per_sm (int)
    "anc_attention_resident": [_I, _I, _P],
    # x, y, bias, g, b, out, R, C, eps, dtype, stream
    "add_layer_norm": [_P] * 6 + [_I, _I, ctypes.c_float, _I, _P],
    # h, bias, R, N, erf form, dtype, stream
    "bias_gelu": [_P, _P] + [_I] * 4 + [_P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None
last_build_seconds: Optional[float] = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as obj_dir:
        srcs = [s for s in _sources() if s.suffix == ".cu"]
        objs = [str(Path(obj_dir) / f"{s.stem}.o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for s, o in zip(srcs, objs)]
        try:
            for s, proc in zip(srcs, procs):
                _, err = proc.communicate(timeout=max(
                    1.0, NVCC_TIMEOUT_S - (time.perf_counter() - t0)))
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {s.name} "
                                       f"({proc.returncode}):\n{err}")
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs],
                capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):"
                                   f"\n{link.stderr}")
            os.replace(tmp, out)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            tmp.unlink(missing_ok=True)
    last_build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"unsupported dtype {t.dtype}; kernels take "
                        f"{list(DTYPE_CODES)}")
    return DTYPE_CODES[t.dtype]


def require(t: torch.Tensor, name: str, device: torch.device, dtype=None,
            shape=None) -> None:
    """Validate a kernel operand before its pointer goes to C."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_filters = {}


def filter_taps(device: torch.device) -> torch.Tensor:
    """The 12 kaiser-sinc taps (ops/alias_free.UP_FILTER) on ``device``."""
    if device not in _filters:
        from index_tts_dubbing_tpu_torch.ops.alias_free import UP_FILTER
        _filters[device] = torch.as_tensor(UP_FILTER, device=device)
    return _filters[device]


_host_taps = None


def host_taps() -> int:
    """Address of the 12 taps as float32 in host memory (kept alive here),
    for the kernels that take them by value."""
    global _host_taps
    if _host_taps is None:
        from index_tts_dubbing_tpu_torch.ops.alias_free import UP_FILTER
        _host_taps = np.ascontiguousarray(UP_FILTER, dtype=np.float32)
    return _host_taps.ctypes.data


_resident = {}


def resident_threads(fn: str, device: torch.device, code: int,
                     vec: int) -> int:
    """Threads of a kernel that the card holds at once: ``fn`` (a
    ``*_resident`` entry point) gives them per SM for (dtype code, vec),
    ``vec`` the kernel's own second parameter (K3's: the head dim)."""
    key = (fn, device, code, vec)
    if key not in _resident:
        per_sm = ctypes.c_int(0)
        check(getattr(load(), fn)(code, vec, ctypes.byref(per_sm)), fn)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _resident[key] = per_sm.value * sms
    return _resident[key]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
