"""Kernel B3: the fused anti-aliased SnakeBeta on channels-last ``(B, T, C)``.

Replaces the Pallas kernel ``fused_anti_alias_snake``
(index_tts_dubbing_tpu/ops/pallas_snake.py:221). It computes what K1
(ops/snake_cmajor.py) computes, with time on dim 1 and the channels
contiguous: per (batch, channel), replicate-pad x along time, ×2 polyphase
upsample through the 12-tap kaiser-sinc FIR (gain 2), SnakeBeta
``v + sin²(αv)·binv`` in float32, 12-tap FIR ×2 decimation; out in the input
dtype. The CUDA source is ``csrc/snake_clast.cu``.

Edge semantics are the Pallas kernel's, as K1's: within ±3 frames of a true
sequence boundary the up-phases are recomputed over the replicated input,
so those outputs differ from the exact route (ops/alias_free.py); the
interior equals it.

``snake_clast`` launches the kernel for a CUDA tensor and takes the plain
version ``snake_clast_plain`` only for a CPU tensor. ``run_plan`` is the
kernel's launch plan: a thread per vector of channels and run of times.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from index_tts_dubbing_tpu_torch.ops import cuda_lib
from index_tts_dubbing_tpu_torch.ops.snake_cmajor import (raw_params,
                                                          snake_cmajor_plain)

VEC = 4          # channels per thread (kVec in csrc/snake_clast.cu)
RING = 6         # the kernel's ring period: runs are whole groups of it
MAX_RUN = 192    # longest run (registers do not grow with it)


def vec_width(c: int, ptrs, element_size: int) -> int:
    """Channels per thread: VEC when C and every pointer allow its vector
    loads and stores (VEC elements, aligned), else 1."""
    align = VEC * element_size
    return VEC if c % VEC == 0 and all(p % align == 0 for p in ptrs) else 1


def run_plan(b: int, t: int, c: int, vec: int,
             resident: int) -> Tuple[int, int, int]:
    """B3's launch plan: (run, runs per batch row, threads). Thread g owns
    the channels (g % (c/vec))·vec .. +vec of batch row g // (c/vec) //
    runs and the output times [r·run, min((r+1)·run, t)), r = g // (c/vec)
    % runs. Of the runs that are whole ring groups up to MAX_RUN, it takes
    the one with the fewest waves × pairs per thread: ceil(threads /
    resident) × (run + 5), where ``resident`` threads fill the card once and
    each run forms 5 pairs of halo. So the grid is whole waves, and a run
    is no shorter than filling the card needs."""
    nv = c // vec
    best = None
    for run in range(RING, MAX_RUN + 1, RING):
        runs = -(-t // run)
        threads = b * runs * nv
        cost = -(-threads // resident) * (run + 5)
        if best is None or cost < best[0]:
            best = (cost, run, runs, threads)
    return best[1:]


def launch_plan(x: torch.Tensor) -> Tuple[int, int, int, int]:
    """(vec, run, runs, threads) of B3 on the CUDA tensor x (B, T, C); the
    output, fresh from the allocator, is aligned."""
    b, t, c = x.shape
    vec = vec_width(c, (x.data_ptr(),), x.element_size())
    code = cuda_lib.dtype_code(x)
    resident = cuda_lib.resident_threads("snake_clast_resident", x.device,
                                         code, vec)
    return (vec, *run_plan(b, t, c, vec, resident))


def snake_clast_plain(x: torch.Tensor, alpha: torch.Tensor,
                      beta: Optional[torch.Tensor],
                      logscale: bool) -> torch.Tensor:
    """The plain PyTorch version of B3: K1's plain version on the (B, C, T)
    view, so the arithmetic and the edges are the same."""
    return snake_cmajor_plain(x.transpose(1, 2), alpha, beta,
                              logscale).transpose(1, 2).contiguous()


def snake_clast(x: torch.Tensor, alpha: torch.Tensor,
                beta: Optional[torch.Tensor], logscale: bool) -> torch.Tensor:
    """(B, T, C) → (B, T, C): kernel B3 on a CUDA tensor, the plain version
    on a CPU tensor."""
    if x.device.type == "cpu":
        return snake_clast_plain(x, alpha, beta, logscale)
    if x.device.type != "cuda":
        raise ValueError(f"snake_clast: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"snake_clast: x must be (B, T, C), got {tuple(x.shape)}")
    b, t, c = x.shape
    cuda_lib.require(x, "x", x.device)
    al, be, pcode = raw_params(alpha, beta, c, x.device)
    code = cuda_lib.dtype_code(x)
    out = torch.empty_like(x)
    vec, run, runs, threads = launch_plan(x)
    rc = cuda_lib.load().snake_clast(
        x.data_ptr(), out.data_ptr(), al.data_ptr(),
        None if be is None else be.data_ptr(), pcode, int(logscale),
        cuda_lib.host_taps(), b, t, c, vec, run, runs, threads, code,
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "snake_clast")
    snake_clast.launches += 1
    return out


snake_clast.launches = 0
