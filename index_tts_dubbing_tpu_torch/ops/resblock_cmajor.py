"""Kernel K2: one whole AMP resblock on C-major ``(B, C, T)``.

Replaces the Pallas kernel ``fused_resblock_cmajor``
(index_tts_dubbing_tpu/ops/pallas_resblock.py:175): 3 × [anti-aliased snake
→ conv k, dilation d → anti-aliased snake → conv k → residual add] over a
tile whose conv inputs and outputs stay in shared memory and registers; only
the float32 residual stream goes to a per-block scratch, which stays in L2.
The CUDA source is ``csrc/resblock_cmajor.cu``: convs on the tensor cores
(float32 as three TF32 passes, ``tf32_split``), built for the padded widths
``KERNEL_WIDTHS``: a call at C ≤ 128 runs on the smallest of them ≥ C
(``kernel_width``), with the weights packed at that width with zeros; the
kernel reads and writes only x's C rows, and the pad channels stay 0.

Numerics, as the Pallas kernel's: activations in float32; each conv rounds
its input to the caller's dtype and accumulates in float32 with a float32
bias; the residual chain stays float32 until the output cast.

Edge semantics: the input is replicate-padded at the true boundaries by the
chain span (``chain_shrink`` ≤ 96 frames) and every op then runs in valid
mode, so the result does not depend on the tile; within the span of a true
boundary it differs from the exact per-op zero-pad route, which the
vocoder's edge patches restore.

``resblock_cmajor`` launches the kernel for a CUDA tensor and takes the
plain version ``resblock_cmajor_plain`` only for a CPU tensor.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch.ops import cuda_lib
from index_tts_dubbing_tpu_torch.ops.alias_free import (DOWN_FILTER, UP_FILTER,
                                                        replicate_pad)

_SMEM_LIMIT = 232448      # dynamic shared memory a block may use on sm_90
_MAX_TILE = 768
_STAGES = 3               # depth of the kernel's weight ring
# the widths K2 is built for (Cp % 8 == 0 and Cp % its weight-stage rows == 0
# in csrc/resblock_cmajor.cu's Plan); 24, 48, 96 are the C ≤ 128 stages of
# the 1536-channel BigVGAN, which run unpadded
KERNEL_WIDTHS = (8, 16, 24, 32, 48, 64, 96, 128)


def _pair_shrink(k: int, d: int) -> int:
    return 12 + (d + 1) * (k - 1) // 2


def chain_shrink(k: int, dils: Sequence[int]) -> int:
    """Frames the 3-pair chain consumes on each side (48/72/96 for k=3/7/11
    at dilations 1, 3, 5)."""
    return sum(_pair_shrink(k, d) for d in dils)


def kernel_width(c: int) -> int:
    """The padded width a resblock of C channels runs on: the smallest of
    ``KERNEL_WIDTHS`` ≥ C. C > 128 raises, as the Pallas kernel asserts."""
    for cp in KERNEL_WIDTHS:
        if c <= cp:
            if c < 1:
                break
            return cp
    raise ValueError(f"resblock_cmajor takes 1 <= C <= 128, got C={c}")


def _cpad(c: int) -> int:
    """Per-tap row stride of the packed weights (the Pallas layout's
    32-aligned stride; the rows between C and Cpad are zero)."""
    return -(-c // 32) * 32


def pack_resblock(rb: Dict[str, Any], cfg, dtype
                  ) -> Tuple[torch.Tensor, ...]:
    """One resblock's params in the kernel's layout at Cp =
    ``kernel_width(C)``: w1/w2 (3, k·Cpad, Cp) in ``dtype`` (Cpad =
    ``_cpad(Cp)`` rows per tap), b1/b2 (3, Cp, 1) float32, acts (3, 4, Cp, 1)
    float32 rows [alpha1, 1/beta1, alpha2, 1/beta2] with the log-scale
    folded. Rows and columns C..Cp-1 are zero, and the pad rows of acts 1,
    so the pad channels stay 0."""
    c = rb["convs1"][0]["b"].shape[0]
    cp = kernel_width(c)

    def flat(w):
        k = w.shape[0]
        w = F.pad(w, (0, cp - c, 0, _cpad(cp) - c))
        return w.reshape(k * _cpad(cp), cp)

    def bias(convs):
        return F.pad(torch.stack([p["b"] for p in convs]).float(),
                     (0, cp - c))[..., None]

    w1 = torch.stack([flat(p["w"]) for p in rb["convs1"]]).to(dtype)
    w2 = torch.stack([flat(p["w"]) for p in rb["convs2"]]).to(dtype)
    b1, b2 = bias(rb["convs1"]), bias(rb["convs2"])
    rows = []
    for a1, a2 in zip(rb["acts"][::2], rb["acts"][1::2]):
        al1, al2 = a1["alpha"].float(), a2["alpha"].float()
        if cfg.activation == "snakebeta":
            be1, be2 = a1["beta"].float(), a2["beta"].float()
        else:
            be1, be2 = al1, al2
        if cfg.snake_logscale:
            al1, be1 = torch.exp(al1), torch.exp(be1)
            al2, be2 = torch.exp(al2), torch.exp(be2)
        rows.append(torch.stack([al1, 1.0 / (be1 + 1e-9),
                                 al2, 1.0 / (be2 + 1e-9)]))
    acts = F.pad(torch.stack(rows), (0, cp - c), value=1.0)
    return w1, b1, w2, b2, acts[..., None].contiguous()


def _act_shrink(v: torch.Tensor, a: torch.Tensor,
                binv: torch.Tensor) -> torch.Tensor:
    """Anti-aliased snake on (B, C, n) float32 → (B, C, n-12); output column
    t' is input column t'+6."""
    n = v.shape[-1]
    m = n - 6
    ue = torch.zeros(*v.shape[:-1], m, device=v.device)
    uo = torch.zeros_like(ue)
    for d in range(6):
        seg = v[..., d: d + m]
        ue = ue + (2.0 * float(UP_FILTER[11 - 2 * d])) * seg
        uo = uo + (2.0 * float(UP_FILTER[10 - 2 * d])) * seg
    s = torch.sin(ue * a)
    ue = ue + binv * s * s
    s = torch.sin(uo * a)
    uo = uo + binv * s * s
    nout = n - 12
    y = torch.zeros(*v.shape[:-1], nout, device=v.device)
    for j in range(12):
        mm = j - 5
        if mm % 2 == 0:
            off = 3 + mm // 2
            y = y + float(DOWN_FILTER[j]) * ue[..., off: off + nout]
        else:
            off = 4 + (mm - 1) // 2
            y = y + float(DOWN_FILTER[j]) * uo[..., off: off + nout]
    return y


def _conv_shrink(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int,
                 d: int, in_dtype) -> torch.Tensor:
    """Valid conv (B, C, n) float32 → (B, C, n - d(k-1)) with the input
    rounded to ``in_dtype`` and float32 accumulation."""
    c = v.shape[1]
    wt = w.float().reshape(k, _cpad(c), -1)[:, :c, :].permute(2, 1, 0)
    return F.conv1d(v.to(in_dtype).float(), wt, dilation=d) + b


def resblock_cmajor_plain(x: torch.Tensor, w1, b1, w2, b2, acts, k: int,
                          dils: Sequence[int]) -> torch.Tensor:
    """What the kernel computes, edges included, in plain torch ops:
    replicate-pad by the chain span, then every op in valid mode. Weights
    packed at a width Cp above x's C (``pack_resblock``) run on x with zero
    channels added, as the kernel does; the result is cut back to C."""
    c, cp = x.shape[1], w1.shape[-1]
    xp = F.pad(x, (0, 0, 0, cp - c)) if cp > c else x
    y = replicate_pad(xp, chain_shrink(k, dils), chain_shrink(k, dils)).float()
    for p, d in enumerate(dils):
        v = _act_shrink(y, acts[p, 0], acts[p, 1])
        v = _conv_shrink(v, w1[p], b1[p], k, d, x.dtype)
        v = _act_shrink(v, acts[p, 2], acts[p, 3])
        v = _conv_shrink(v, w2[p], b2[p], k, 1, x.dtype)
        s = _pair_shrink(k, d)
        y = v + y[..., s: y.shape[-1] - s]
    return y[:, :c].to(x.dtype)


def _gemm_plan(c: int) -> Tuple[int, int, int]:
    """K2's GEMM plan at C channels, as in ``csrc/resblock_cmajor.cu``'s
    ``Plan``: (padded output rows, Cin rows per weight stage, slab row
    stride)."""
    cm = -(-c // 16) * 16
    return cm, (c if c <= 48 else 32), cm + 8


def _lda(w: int) -> int:
    """Row stride of the kernel's shared buffer for a W-column tile: ≥ W-12,
    and 8 or 24 modulo 32 words (conflict-free tensor-core operand loads)."""
    return -(-(w - 12) // 16) * 16 + 8


def smem_bytes(c: int, w: int) -> int:
    """Shared memory of one K2 block at C channels (float32 sizes): the
    float32 conv/activation buffer (Cp, lda) and the 3-stage weight ring,
    at Cp = ``kernel_width(C)``."""
    cp = kernel_width(c)
    _, ks, ldw = _gemm_plan(cp)
    return 4 * cp * _lda(w) + 4 * _STAGES * ks * ldw


def pick_tile(c: int, k: int, dils: Sequence[int], t: int) -> int:
    """Output columns per block: the largest multiple of 32 (≤ 768, ≤ t
    rounded up) whose conv/activation buffer and weight ring fit in one
    block's shared memory at ``kernel_width(C)``; the residual stream lives
    in device scratch (288 at C = 96, k = 11; 128 at C = 128, k = 11)."""
    w_halo = 2 * chain_shrink(k, dils)
    tt = min(_MAX_TILE, -(-t // 32) * 32)
    while tt >= 32 and smem_bytes(c, tt + w_halo) > _SMEM_LIMIT:
        tt -= 32
    if tt < 32:
        raise ValueError(f"resblock_cmajor: C={c}, k={k} does not fit one "
                         f"block's shared memory")
    return tt


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's float32 operand split, in plain torch: hi = tf32(x),
    lo = tf32(x - hi), each rounded as ``cvt.rna.tf32.f32`` rounds (to
    nearest, ties away from zero, 10 explicit mantissa bits). hi·hi +
    hi·lo + lo·hi is the kernel's 3-pass product. Finite inputs only."""
    def rna(v: torch.Tensor) -> torch.Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def resblock_cmajor(x: torch.Tensor, w1, b1, w2, b2, acts, k: int,
                    dils: Sequence[int]) -> torch.Tensor:
    """One AMP resblock (B, C, T) → (B, C, T), C ≤ 128, with weights from
    ``pack_resblock``: kernel K2 on a CUDA tensor, the plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return resblock_cmajor_plain(x, w1, b1, w2, b2, acts, k, dils)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_cmajor: unsupported device {x.device}")
    if x.dim() != 3 or len(dils) != 3:
        raise ValueError("resblock_cmajor: x must be (B, C, T) with 3 dilations")
    b, c, t = x.shape
    cw = kernel_width(c)
    cpad = _cpad(cw)
    dev = x.device
    cuda_lib.require(x, "x", dev)
    for name, wt in (("w1", w1), ("w2", w2)):
        cuda_lib.require(wt, name, dev, x.dtype, (3, k * cpad, cw))
        if wt.data_ptr() % 16:
            raise ValueError(f"resblock_cmajor: {name} must be 16-byte aligned")
    for name, bt in (("b1", b1), ("b2", b2)):
        cuda_lib.require(bt, name, dev, torch.float32, (3, cw, 1))
    cuda_lib.require(acts, "acts", dev, torch.float32, (3, 4, cw, 1))
    code = cuda_lib.dtype_code(x)
    tt = pick_tile(c, k, dils, t)
    w = tt + 2 * chain_shrink(k, dils)
    out = torch.empty_like(x)
    # the residual stream of every block, float32 (Cp, tt + 2·span)
    scratch = torch.empty(b * -(-t // tt) * cw * w, device=dev,
                          dtype=torch.float32)
    lib = cuda_lib.load()
    rc = lib.resblock_cmajor(
        x.data_ptr(), out.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), acts.data_ptr(),
        cuda_lib.filter_taps(dev).data_ptr(), scratch.data_ptr(), b, c, cw, t,
        k, *dils, tt, cpad, code, cuda_lib.stream_ptr(dev))
    cuda_lib.check(rc, "resblock_cmajor")
    resblock_cmajor.launches += 1
    return out


resblock_cmajor.launches = 0
