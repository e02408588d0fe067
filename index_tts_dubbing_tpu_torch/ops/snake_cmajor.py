"""Kernel K1: the fused anti-aliased SnakeBeta on C-major ``(B, C, T)``.

Replaces the Pallas kernel ``fused_anti_alias_snake_cmajor``
(index_tts_dubbing_tpu/ops/pallas_snake.py:168). Per row and time: replicate-
pad x, ×2 polyphase upsample through the 12-tap kaiser-sinc FIR (gain 2),
SnakeBeta ``v + sin²(αv)·binv`` in float32, 12-tap FIR ×2 decimation; out in
the input dtype. The CUDA source is ``csrc/snake_cmajor.cu``.

Edge semantics (as the Pallas kernel's): the up-phases near a true sequence
boundary are recomputed over the replicated input rather than replicating
the upsampled edge, so outputs within ±3 frames of a boundary differ from
the exact route (ops/alias_free.py); the interior equals it.

``snake_cmajor`` launches the kernel for a CUDA tensor and takes the plain
version ``snake_cmajor_plain`` only for a CPU tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from index_tts_dubbing_tpu_torch.ops import cuda_lib
from index_tts_dubbing_tpu_torch.ops.alias_free import (DOWN_FILTER, UP_FILTER,
                                                        replicate_pad)

_PAD = 6  # input frames each output depends on, each side


def fold_params(alpha: torch.Tensor, beta: Optional[torch.Tensor],
                logscale: bool, channels: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 (a, binv) with any log-scale applied, as the
    Pallas wrapper folds them (exp in the parameter's own dtype)."""
    if logscale:
        a = torch.exp(alpha)
        bta = torch.exp(beta) if beta is not None else None
    else:
        a, bta = alpha, beta
    binv = 1.0 / ((bta if bta is not None else a).float() + 1e-9)
    return (a.float().reshape(channels).contiguous(),
            binv.reshape(channels).contiguous())


def snake_cmajor_plain(x: torch.Tensor, alpha: torch.Tensor,
                       beta: Optional[torch.Tensor],
                       logscale: bool) -> torch.Tensor:
    """The plain PyTorch version of K1: what the kernel computes, edges
    included — replicate-pad by 6, up-phases → snake → decimation in valid
    mode."""
    a, binv = fold_params(alpha, beta, logscale, x.shape[1])
    t = x.shape[-1]
    n = t + 6                          # up-phase samples u ∈ [-3, t+3)
    xp = replicate_pad(x.float(), _PAD, _PAD)
    av, bv = a[:, None], binv[:, None]
    ue = torch.zeros(*x.shape[:-1], n, device=x.device)
    uo = torch.zeros_like(ue)
    for d in range(6):
        ue = ue + (2.0 * float(UP_FILTER[11 - 2 * d])) * xp[..., d: d + n]
        uo = uo + (2.0 * float(UP_FILTER[10 - 2 * d])) * xp[..., 1 + d: 1 + d + n]
    s = torch.sin(ue * av)
    ue = ue + bv * s * s
    s = torch.sin(uo * av)
    uo = uo + bv * s * s
    y = torch.zeros(*x.shape[:-1], t, device=x.device)
    for j in range(12):
        m = j - 5                      # up index offset 2t + m
        if m % 2 == 0:
            y = y + float(DOWN_FILTER[j]) * ue[..., 3 + m // 2: 3 + m // 2 + t]
        else:
            off = 3 + (m - 1) // 2
            y = y + float(DOWN_FILTER[j]) * uo[..., off: off + t]
    return y.to(x.dtype)


def snake_cmajor(x: torch.Tensor, alpha: torch.Tensor,
                 beta: Optional[torch.Tensor], logscale: bool) -> torch.Tensor:
    """(B, C, T) → (B, C, T): kernel K1 on a CUDA tensor, the plain version
    on a CPU tensor."""
    if x.device.type == "cpu":
        return snake_cmajor_plain(x, alpha, beta, logscale)
    if x.device.type != "cuda":
        raise ValueError(f"snake_cmajor: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"snake_cmajor: x must be (B, C, T), got {tuple(x.shape)}")
    b, c, t = x.shape
    a, binv = fold_params(alpha, beta, logscale, c)
    cuda_lib.require(x, "x", x.device)
    cuda_lib.require(a, "a", x.device, torch.float32, (c,))
    cuda_lib.require(binv, "binv", x.device, torch.float32, (c,))
    code = cuda_lib.dtype_code(x)
    out = torch.empty_like(x)
    lib = cuda_lib.load()
    rc = lib.snake_cmajor(x.data_ptr(), out.data_ptr(), a.data_ptr(),
                          binv.data_ptr(),
                          cuda_lib.filter_taps(x.device).data_ptr(),
                          b * c, c, t, code, cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "snake_cmajor")
    snake_cmajor.launches += 1
    return out


snake_cmajor.launches = 0
