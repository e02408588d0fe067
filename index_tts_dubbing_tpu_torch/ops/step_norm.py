"""Kernel K4: the elementwise chains between the beam decode step's GEMMs,
two entry points, one launch each.

Replaces no TPU kernel: the JAX package's beam step
(index_tts_dubbing_tpu/models/gpt.py, ``trunk_decode_step_split_anc``) is
plain XLA ops, as the plain versions here are plain PyTorch. K4 (CUDA
source ``csrc/step_norm.cu``) runs each chain in one launch:

- ``add_layer_norm``: the residual add of a GEMM's output and its bias,
  then a LayerNorm of the new residual (``nn.linear``'s bias add,
  ``x + ...`` and ``nn.layer_norm``: ~11 plain kernels);
- ``bias_gelu``: the fc GEMM's bias add and the activation
  (``nn.linear``'s bias add and ``nn.gelu_tanh`` or ``nn.gelu_exact``: ~9
  plain kernels).

Numerics, as the plain chain's: the bias rounded to the compute dtype and
added, that sum rounded, the residual add rounded (so the residual stream
is the plain chain's bit for bit); the LayerNorm's mean and variance in
float32 in two passes and its scale and shift in float32, then one cast;
GELU in float32 with an accurate ``tanhf``. Only the float32 summation
order behind the LayerNorm's statistics differs from the plain chain, so
its output may differ by an ulp of the compute dtype.

Both write in place where the plain chain made a temporary: the new
residual over the GEMM output ``y``, the activation over ``h``. Each
launches K4 for a CUDA tensor and takes the plain version only for a CPU
tensor. ``launches`` on each wrapper counts its launches.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.ops import cuda_lib

Params = Dict[str, Any]
MAX_VECS = 4 * 1024     # 16-byte vectors a row of add_layer_norm may hold


def add_layer_norm_plain(x: torch.Tensor, y: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], p: Params,
                         eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``add_layer_norm``: with ``y``, the new
    residual ``x + (y + bias)`` written over ``y``; then its LayerNorm."""
    if y is not None:
        if bias is not None:
            y.add_(bias.to(y.dtype))
        x = y.add_(x)
    return x, nn.layer_norm(p, x, eps)


def bias_gelu_plain(h: torch.Tensor, bias: Optional[torch.Tensor],
                    erf: bool) -> torch.Tensor:
    """The plain PyTorch version of ``bias_gelu``: ``act(h + bias)``
    written over ``h``."""
    if bias is not None:
        h.add_(bias.to(h.dtype))
    return h.copy_(nn.gelu_exact(h) if erf else nn.gelu_tanh(h))


def _rows(t: torch.Tensor, name: str, dev: torch.device, dtype,
          width: int) -> None:
    """A kernel operand: on ``dev`` in ``dtype``, contiguous, rows of
    ``width`` values, 16-byte aligned."""
    cuda_lib.require(t, name, dev, dtype)
    if t.shape[-1] != width or t.data_ptr() % 16:
        raise ValueError(f"step_norm: {name} must have rows of {width} "
                         f"values, 16-byte aligned; got {tuple(t.shape)}")


def _device(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def add_layer_norm(x: torch.Tensor, y: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], p: Params,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual stream after one more sublayer, and its LayerNorm.
    x (..., C) the residual; y the sublayer's GEMM output, shaped as x,
    or None (the residual as it is); bias (C,) the GEMM's bias or None;
    ``p`` the LayerNorm's ``g`` and ``b`` (C,), on a card in x's dtype.
    Returns (x', LN(x')) where x' = x + (y + bias) is written over ``y``
    (x itself without ``y``). Kernel K4 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not _device(x, "add_layer_norm"):
        return add_layer_norm_plain(x, y, bias, p, eps)
    dev, c = x.device, x.shape[-1]
    code = cuda_lib.dtype_code(x)
    vec = 16 // x.element_size()
    if c % vec or c // vec > MAX_VECS:
        raise ValueError(f"add_layer_norm: rows of {c} values in {x.dtype}; "
                         f"K4 takes a multiple of {vec} up to "
                         f"{vec * MAX_VECS}")
    if y is None and bias is not None:
        raise ValueError("add_layer_norm: a bias needs the GEMM output y")
    _rows(x, "x", dev, x.dtype, c)
    if y is not None:
        _rows(y, "y", dev, x.dtype, c)
        if y.shape != x.shape or y.data_ptr() == x.data_ptr():
            raise ValueError(f"add_layer_norm: y {tuple(y.shape)} must be "
                             f"another tensor shaped as x {tuple(x.shape)}")
    if bias is not None:
        bias = bias.to(x.dtype)
        _rows(bias, "bias", dev, x.dtype, c)
    g, b = p["g"], p["b"]
    _rows(g, "g", dev, x.dtype, c)
    _rows(b, "b", dev, x.dtype, c)
    out = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = cuda_lib.load().add_layer_norm(
        x.data_ptr(), ptr(y), ptr(bias), g.data_ptr(), b.data_ptr(),
        out.data_ptr(), x.numel() // c, c, eps, code,
        cuda_lib.stream_ptr(dev))
    cuda_lib.check(rc, "add_layer_norm")
    add_layer_norm.launches += 1
    return (x if y is None else y), out


def bias_gelu(h: torch.Tensor, bias: Optional[torch.Tensor],
              erf: bool = False) -> torch.Tensor:
    """``act(h + bias)`` over the fc GEMM's output h (..., N), written over
    ``h`` and returned; ``act`` the tanh form of GELU, or with ``erf`` the
    exact one. Kernel K4 on a CUDA tensor, the plain version on a CPU
    tensor."""
    if not _device(h, "bias_gelu"):
        return bias_gelu_plain(h, bias, erf)
    dev, n = h.device, h.shape[-1]
    code = cuda_lib.dtype_code(h)
    vec = 16 // h.element_size()
    if n % vec:
        raise ValueError(f"bias_gelu: rows of {n} values in {h.dtype}; K4 "
                         f"takes a multiple of {vec}")
    _rows(h, "h", dev, h.dtype, n)
    if bias is not None:
        bias = bias.to(h.dtype)
        _rows(bias, "bias", dev, h.dtype, n)
    rc = cuda_lib.load().bias_gelu(
        h.data_ptr(), None if bias is None else bias.data_ptr(),
        h.numel() // n, n, int(erf), code, cuda_lib.stream_ptr(dev))
    cuda_lib.check(rc, "bias_gelu")
    bias_gelu.launches += 1
    return h


def launches() -> int:
    """K4's launches so far, both entry points."""
    return add_layer_norm.launches + bias_gelu.launches


add_layer_norm.launches = 0
bias_gelu.launches = 0
