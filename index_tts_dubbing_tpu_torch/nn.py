"""Functional layers over plain parameter dictionaries (PyTorch).

Counterpart of the JAX package's ``nn.py``. Parameters are nested dicts of
tensors in the JAX package's layouts, so carried-over weights need no
re-layout beyond what each function does at call time:

- activations ``(B, T, C)`` channels-last;
- conv1d kernels ``(K, Cin/groups, Cout)``; linear kernels ``(Cin, Cout)``;
- conv_transpose1d kernels ``(K, Cout, Cin)``; conv2d kernels HWIO.

Numerics follow the JAX functions: weights are cast to the input's dtype,
norms and softmax run in float32 inside, and products that the JAX package
accumulates into float32 (``preferred_element_type=float32``) multiply
float32 copies of their operands.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

Params = Dict[str, Any]
Padding = Union[int, Tuple[int, int]]


def linear(p: Params, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    """x @ w, then ``p["b"]`` where the layer has one and ``bias`` is set
    (a caller that adds the bias itself passes ``bias=False``)."""
    if "w_q" in p:
        # weight-only int8 (utils/quant.py): the int8 weight cast to x's
        # dtype for the product, then the per-column scale on the (much
        # smaller) output; no dequantized copy is kept
        y = torch.matmul(x, p["w_q"].to(x.dtype)) * p["scale"].to(x.dtype)
    else:
        y = torch.matmul(x, p["w"].to(x.dtype))
    if bias and "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["w"][ids]


def _pad_pair(padding: Padding) -> Tuple[int, int]:
    return (padding, padding) if isinstance(padding, int) else tuple(padding)


def conv1d(p: Params, x: torch.Tensor, *, stride: int = 1, dilation: int = 1,
           padding: Padding = 0, groups: int = 1) -> torch.Tensor:
    """1-D conv over (B, T, C); ``padding`` an int (symmetric) or (lo, hi)."""
    lo, hi = _pad_pair(padding)
    xt = F.pad(x.transpose(1, 2), (lo, hi))
    w = p["w"].to(x.dtype).permute(2, 1, 0)          # (Cout, Cin/g, K)
    y = F.conv1d(xt, w, stride=stride, dilation=dilation, groups=groups)
    y = y.transpose(1, 2)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def conv_transpose1d(p: Params, x: torch.Tensor, *, stride: int,
                     padding: int = 0) -> torch.Tensor:
    """torch-semantics transposed conv over (B, T, C):
    out_len = (T-1)*stride + K - 2*padding."""
    w = p["w"].to(x.dtype).permute(2, 1, 0)          # (Cin, Cout, K)
    y = F.conv_transpose1d(x.transpose(1, 2), w, stride=stride,
                           padding=padding).transpose(1, 2)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def conv2d(p: Params, x: torch.Tensor, *, stride=(1, 1),
           padding=((0, 0), (0, 0))) -> torch.Tensor:
    """2-D conv over (B, H, W, C) with an HWIO kernel; ``padding`` zero pads
    ((top, bottom), (left, right)) first (the default is VALID)."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)       # (O, I, H, W)
    (top, bottom), (left, right) = padding
    xt = x.permute(0, 3, 1, 2)
    if top or bottom or left or right:
        xt = F.pad(xt, (left, right, top, bottom))
    y = F.conv2d(xt, w, stride=stride).permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(x.dtype)


def group_norm(p: Params, x: torch.Tensor, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (B, T, C), normalising each group over (T, C/groups)."""
    b, t, c = x.shape
    xf = x.float().reshape(b, t, groups, c // groups)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mu).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, t, c)
    return (y * p["g"] + p["b"]).to(x.dtype)


def batch_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode batch norm over the channel (last) axis of (B, T, C)."""
    scale = p["g"] * torch.rsqrt(p["var"] + eps)
    shift = p["b"] - p["mean"] * scale
    return (x.float() * scale + shift).to(x.dtype)


def rms_norm_l2(p: Params, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """out = x / max(||x||_2, eps) * sqrt(dim) * gamma."""
    xf = x.float()
    norm = xf.square().sum(-1, keepdim=True).sqrt()
    y = xf / torch.clamp(norm, min=eps) * math.sqrt(x.shape[-1])
    return (y * p["g"]).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu_pytorch_tanh / gelu_new, computed in float32."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                     * (xf + 0.044715 * xf ** 3)))
    return y.to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,Tq,D), k/v (B,H,Tk,D); mask broadcastable to (B,H,Tq,Tk),
    True = attend. Scores and softmax in float32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.tensor(-1e30, device=q.device))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(w, v)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, heads, c // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def write_slot(t: torch.Tensor, dim: int, slot: Union[int, torch.Tensor],
               value: torch.Tensor) -> None:
    """``t`` at index ``slot`` of axis ``dim`` set to ``value`` (broadcast to
    ``t`` without that axis), in place. A 0-d device tensor ``slot`` is read
    on the device (``index_copy_``), so a CUDA graph can capture the write."""
    if not torch.is_tensor(slot):
        t.select(dim, slot).copy_(value)
        return
    shape = t.select(dim, 0).shape
    t.index_copy_(dim, slot.reshape(1), value.expand(shape).unsqueeze(dim))


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """True where padded. lengths (B,), out (B, max_len)."""
    ar = torch.arange(max_len, device=lengths.device)[None, :]
    return ar >= lengths[:, None]

