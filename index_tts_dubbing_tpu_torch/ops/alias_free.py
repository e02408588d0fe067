"""Anti-aliased activation ops (BigVGAN's alias-free snake path), exact route.

Counterpart of the JAX package's ``ops/alias_free.py``: replicate-pad →
×2 upsample through the 12-tap kaiser-sinc FIR → snake(beta) →
replicate-pad → 12-tap low-pass FIR → ×2 downsample, each FIR written as a
polyphase shift-add. These functions work on the LAST axis (time), so they
serve the C-major ``(B, C, T)`` vocoder directly; per-channel α/β broadcast
over dim 1.

``anti_aliased_activation_cmajor(..., use_kernel=False)`` is the exact
route's activation: each call replicate-pads its own input for the ×2
upsampler and its ×2 snake signal for the downsampler. It is the CPU's and
the reference's route. With ``use_kernel=True`` it runs kernel K1
(ops/snake_cmajor.py); by default K1 recomputes the up-phases over the
replicated input, which differs within ±3 frames of the tensor's ends, and
with ``exact_edge`` K1 pads as this route does: the exact route's semantics
on the card.

``anti_aliased_activation`` is the channels-last ``(B, T, C)`` form the
reference-structured BigVGAN (models/bigvgan.py) uses: the same ops on a
transposed view, or with ``use_pallas=True`` kernel B3
(ops/snake_clast.py), with B3's edge semantics.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def kaiser_beta(A: float) -> float:
    if A > 50.0:
        return 0.1102 * (A - 8.7)
    if A >= 21.0:
        return 0.5842 * (A - 21.0) ** 0.4 + 0.07886 * (A - 21.0)
    return 0.0


def kaiser_sinc_filter1d(cutoff: float, half_width: float,
                         kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass, normalised to sum 1 (even kernel,
    half-sample offsets)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4.0 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    window = np.kaiser(kernel_size, kaiser_beta(A))
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, np.float32)
    filt = 2.0 * cutoff * window * np.sinc(2.0 * cutoff * time)
    return (filt / filt.sum()).astype(np.float32)


# 2x up/down filters used everywhere in BigVGAN (ratio 2, kernel 12).
UP_FILTER = kaiser_sinc_filter1d(0.5 / 2, 0.6 / 2, 12)
DOWN_FILTER = UP_FILTER


def replicate_pad(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Replicate-pad the last axis."""
    parts = []
    if lo:
        parts.append(x[..., :1].expand(*x.shape[:-1], lo))
    parts.append(x)
    if hi:
        parts.append(x[..., -1:].expand(*x.shape[:-1], hi))
    return torch.cat(parts, dim=-1)


def upsample2(x: torch.Tensor, filt: np.ndarray = UP_FILTER) -> torch.Tensor:
    """×2 anti-aliased upsample along the last axis (replicate pad 5, 12-tap
    FIR transposed conv stride 2, crop 15/15, gain 2) as a 6-tap polyphase
    shift-add per output phase."""
    t = x.shape[-1]
    k = filt.shape[0]
    xp = replicate_pad(x, k // 2 - 1, k // 2 - 1)
    even = torch.zeros_like(x)
    odd = torch.zeros_like(x)
    for i in range(k // 2):
        even = even + (2.0 * float(filt[k - 1 - 2 * i])) * xp[..., 2 + i: 2 + i + t]
        odd = odd + (2.0 * float(filt[k - 2 - 2 * i])) * xp[..., 3 + i: 3 + i + t]
    return torch.stack([even, odd], dim=-1).reshape(*x.shape[:-1], 2 * t)


def downsample2(x: torch.Tensor, filt: np.ndarray = DOWN_FILTER) -> torch.Tensor:
    """×2 anti-aliased downsample along the last axis (stride-2 12-tap FIR,
    replicate pad 5/6), polyphase over the two input phases."""
    k = filt.shape[0]
    xp = replicate_pad(x, k // 2 - 1, k // 2)
    t_out = x.shape[-1] // 2
    xe = xp[..., 0::2]
    xo = xp[..., 1::2]
    y = torch.zeros(*x.shape[:-1], t_out, dtype=x.dtype, device=x.device)
    for j in range(k // 2):
        y = y + float(filt[2 * j]) * xe[..., j: j + t_out]
        y = y + float(filt[2 * j + 1]) * xo[..., j: j + t_out]
    return y


def snake(x: torch.Tensor, alpha: torch.Tensor, logscale: bool) -> torch.Tensor:
    """x + (1/α)·sin²(αx) with per-channel α on dim 1."""
    return snake_beta(x, alpha, None, logscale)


def snake_beta(x: torch.Tensor, alpha: torch.Tensor,
               beta: Optional[torch.Tensor], logscale: bool) -> torch.Tensor:
    """x + (1/β)·sin²(αx) with per-channel α, β on dim 1 (β = α when None,
    which is plain snake)."""
    if logscale:
        alpha = torch.exp(alpha)
        beta = torch.exp(beta) if beta is not None else None
    a = alpha.float()[:, None]
    bta = beta.float()[:, None] if beta is not None else a
    return snake_folded(x, a, 1.0 / (bta + 1e-9))


def snake_folded(x: torch.Tensor, a: torch.Tensor,
                 binv: torch.Tensor) -> torch.Tensor:
    """x + binv·sin²(a·x) in float32 with the folded float32 parameters a
    and binv = 1/(β + 1e-9), each (C, 1) over dim 1; out in x's dtype."""
    xf = x.float()
    return (xf + binv * torch.sin(xf * a).square()).to(x.dtype)


def anti_aliased_activation_cmajor(x: torch.Tensor, alpha: torch.Tensor,
                                   beta: Optional[torch.Tensor], logscale: bool,
                                   use_kernel: bool = True,
                                   exact_edge: bool = False) -> torch.Tensor:
    """(B, C, T) → (B, C, T): up → snake(beta) → down along time.
    ``use_kernel``: K1, in its exact-edge mode with ``exact_edge``."""
    if use_kernel:
        from index_tts_dubbing_tpu_torch.ops.snake_cmajor import snake_cmajor
        return snake_cmajor(x, alpha, beta, logscale, exact_edge=exact_edge)
    return downsample2(snake_beta(upsample2(x), alpha, beta, logscale))


def anti_aliased_activation(x: torch.Tensor, alpha: torch.Tensor,
                            beta: Optional[torch.Tensor], logscale: bool,
                            use_pallas: bool = False) -> torch.Tensor:
    """(B, T, C) → (B, T, C): up → snake (β absent) or snake_beta → down
    along time. ``use_pallas`` runs kernel B3, the JAX flag's name kept."""
    if use_pallas:
        from index_tts_dubbing_tpu_torch.ops.snake_clast import snake_clast
        return snake_clast(x, alpha, beta, logscale)
    y = upsample2(x.transpose(1, 2))
    y = (snake(y, alpha, logscale) if beta is None
         else snake_beta(y, alpha, beta, logscale))
    return downsample2(y).transpose(1, 2)
