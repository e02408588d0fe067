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
version ``snake_clast_plain`` only for a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from index_tts_dubbing_tpu_torch.ops import cuda_lib
from index_tts_dubbing_tpu_torch.ops.snake_cmajor import (fold_params,
                                                          snake_cmajor_plain)


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
    a, binv = fold_params(alpha, beta, logscale, c)
    cuda_lib.require(x, "x", x.device)
    cuda_lib.require(a, "a", x.device, torch.float32, (c,))
    cuda_lib.require(binv, "binv", x.device, torch.float32, (c,))
    code = cuda_lib.dtype_code(x)
    out = torch.empty_like(x)
    lib = cuda_lib.load()
    rc = lib.snake_clast(x.data_ptr(), out.data_ptr(), a.data_ptr(),
                         binv.data_ptr(),
                         cuda_lib.filter_taps(x.device).data_ptr(),
                         b, t, c, code, cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "snake_clast")
    snake_clast.launches += 1
    return out


snake_clast.launches = 0
