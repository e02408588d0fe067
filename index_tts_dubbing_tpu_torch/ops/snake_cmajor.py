"""Kernel K1: the fused anti-aliased SnakeBeta on C-major ``(B, C, T)``.

Replaces the Pallas kernel ``fused_anti_alias_snake_cmajor``
(index_tts_dubbing_tpu/ops/pallas_snake.py:168). Per row and time: replicate-
pad x, ×2 polyphase upsample through the 12-tap kaiser-sinc FIR (gain 2),
SnakeBeta ``v + sin²(αv)·binv`` in float32, 12-tap FIR ×2 decimation; out in
the input dtype. The CUDA source is ``csrc/snake_cmajor.cu``.

Edge semantics (as the Pallas kernel's): the up-phases near a true sequence
boundary are recomputed over the replicated input rather than replicating
the upsampled edge, so outputs within ±3 frames of a boundary differ from
the exact route (ops/alias_free.py); the interior equals it. In the
exact-edge mode (``exact_edge=True``, one flag a launch) the ×2 snake
signal is replicate-padded at each row's two ends instead, which is the
exact route's semantics over the whole tensor; the plain version of that
mode is the exact route's own ops, the CPU's and the reference's route.

``snake_cmajor`` launches the kernel for a CUDA tensor and takes the plain
version ``snake_cmajor_plain`` only for a CPU tensor. ``lane_plan`` is the
kernel's launch plan: runs of ``RUN`` outputs per lane, rows laid end to
end over passes of 32 lanes, one wave of warps each walking a chunk of
consecutive passes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from index_tts_dubbing_tpu_torch.ops import cuda_lib
from index_tts_dubbing_tpu_torch.ops.alias_free import (
    DOWN_FILTER, UP_FILTER, anti_aliased_activation_cmajor, replicate_pad)

_PAD = 6  # input frames each output depends on, each side
RUN = 8   # outputs per lane (kRun in csrc/snake_cmajor.cu): two 16-byte loads
STORING_LANES = 31   # lanes 0-30 of a pass store; lane 31 lends its pairs


def lane_plan(rows: int, t: int, resident_warps: int) -> Tuple[int, int, int]:
    """K1's launch plan for ``rows`` rows of ``t`` outputs: (lanes per row,
    passes, chunk). A row takes ceil(t/RUN) lanes of RUN outputs and one
    helper lane past its end (its pairs finish the row's last run). Virtual
    lane v is row v // lanes, first output (v % lanes)·RUN; pass p holds
    lanes 31p .. 31p+31, of which 0-30 store, so every lane that stores has
    the lane after it in its pass. Warp w walks the passes [w·chunk,
    (w+1)·chunk): no more warps than the card holds at once (one wave)."""
    lanes = -(-t // RUN) + 1
    passes = -(-(rows * lanes - 1) // STORING_LANES) if rows and t else 0
    chunk = -(-passes // min(passes, resident_warps)) if passes else 1
    return lanes, passes, chunk


def launch_plan(x: torch.Tensor) -> Tuple[int, int, int, int]:
    """(vec, lanes per row, passes, chunk) of K1 on the CUDA tensor x
    (B, C, T): the 16-byte path when T % RUN == 0 and x is 16-byte aligned
    (the output, fresh from the allocator, is)."""
    b, c, t = x.shape
    vec = int(t % RUN == 0 and x.data_ptr() % 16 == 0)
    resident = cuda_lib.resident_threads("snake_cmajor_resident", x.device,
                                         cuda_lib.dtype_code(x), vec)
    return (vec, *lane_plan(b * c, t, resident // 32))


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


def raw_params(alpha: torch.Tensor, beta: Optional[torch.Tensor],
               channels: int, device: torch.device
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """alpha and beta (or None) as the kernels take them, to fold into
    (a, binv) as ``fold_params`` does: ``channels`` contiguous elements
    each, one dtype (float32 or bfloat16, its code last), on ``device``."""
    al = alpha.reshape(channels).contiguous()
    cuda_lib.require(al, "alpha", device)
    if beta is not None:
        beta = beta.reshape(channels).contiguous()
        cuda_lib.require(beta, "beta", device, al.dtype)
    return al, beta, cuda_lib.dtype_code(al)


def snake_cmajor_plain(x: torch.Tensor, alpha: torch.Tensor,
                       beta: Optional[torch.Tensor], logscale: bool,
                       exact_edge: bool = False) -> torch.Tensor:
    """The plain PyTorch version of K1: what the kernel computes, edges
    included — replicate-pad by 6, up-phases → snake → decimation in valid
    mode. With ``exact_edge``: the exact route's activation
    (ops/alias_free.py), bit for bit."""
    if exact_edge:
        return anti_aliased_activation_cmajor(x, alpha, beta, logscale,
                                              use_kernel=False)
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
                 beta: Optional[torch.Tensor], logscale: bool,
                 exact_edge: bool = False) -> torch.Tensor:
    """(B, C, T) → (B, C, T): kernel K1 on a CUDA tensor, the plain version
    on a CPU tensor; ``exact_edge``: the exact-edge mode."""
    if x.device.type == "cpu":
        return snake_cmajor_plain(x, alpha, beta, logscale, exact_edge)
    if x.device.type != "cuda":
        raise ValueError(f"snake_cmajor: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"snake_cmajor: x must be (B, C, T), got {tuple(x.shape)}")
    b, c, t = x.shape
    cuda_lib.require(x, "x", x.device)
    al, be, pcode = raw_params(alpha, beta, c, x.device)
    code = cuda_lib.dtype_code(x)
    out = torch.empty_like(x)
    vec, lanes, passes, chunk = launch_plan(x)
    rc = cuda_lib.load().snake_cmajor(
        x.data_ptr(), out.data_ptr(), al.data_ptr(),
        None if be is None else be.data_ptr(), pcode, int(logscale),
        cuda_lib.host_taps(), b * c, c, t, RUN, vec, lanes, passes, chunk,
        int(exact_edge), code, cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "snake_cmajor")
    snake_cmajor.launches += 1
    return out


snake_cmajor.launches = 0
