"""SincConv (SincNet) band-pass filterbank convolution.

Counterpart of the JAX package's ``ops/sinc_conv.py``, after the
speechbrain-style module the reference vendors (BigVGAN/nnet/CNN.py,
class SincConv): a learnable low cutoff and bandwidth in Hz per filter;
the filters are built on the fly as Hamming-windowed sinc band-passes and
applied as a grouped 1-D convolution. The reference's inference path does
not use it (its ECAPA reads mel input).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _to_mel(hz: np.ndarray) -> np.ndarray:
    return 2595 * np.log10(1 + np.asarray(hz, np.float64) / 700)


def _to_hz(mel: np.ndarray) -> np.ndarray:
    return 700 * (10 ** (np.asarray(mel, np.float64) / 2595) - 1)


def init(out_channels: int, kernel_size: int, sample_rate: int = 16000,
         min_low_hz: float = 50.0, min_band_hz: float = 50.0,
         device="cuda") -> Params:
    """Mel-spaced initial cutoffs. kernel_size must be odd."""
    if kernel_size % 2 == 0:
        raise ValueError("kernel_size must be odd")
    high_hz = sample_rate / 2 - (min_low_hz + min_band_hz)
    mel = np.linspace(_to_mel(np.array(min_low_hz)),
                      _to_mel(np.array(high_hz)), out_channels + 1)
    hz = _to_hz(mel)
    return {
        "low_hz": torch.as_tensor(hz[:-1, None].astype(np.float32),
                                  device=device),
        "band_hz": torch.as_tensor((hz[1:] - hz[:-1])[:, None]
                                   .astype(np.float32), device=device),
    }


def _filters(p: Params, kernel_size: int, sample_rate: int,
             min_low_hz: float, min_band_hz: float) -> torch.Tensor:
    """Windowed-sinc band-pass filter bank (out, k)."""
    dev = p["low_hz"].device
    half = kernel_size // 2
    # Hamming window over the left half
    n_lin = torch.linspace(0.0, kernel_size / 2 - 1, half, device=dev)
    window = 0.54 - 0.46 * torch.cos(2 * math.pi * n_lin / kernel_size)
    # time axis: 2π·[-half..-1]/sr
    n_ = (2 * math.pi * torch.arange(-half, 0, dtype=torch.float32,
                                     device=dev) / sample_rate)[None, :]
    low = min_low_hz + p["low_hz"].float().abs()
    high = torch.clamp(low + min_band_hz + p["band_hz"].float().abs(),
                       min_low_hz, sample_rate / 2)
    band = (high - low)[:, 0]
    f_low = low @ n_
    f_high = high @ n_
    left = ((torch.sin(f_high) - torch.sin(f_low)) / (n_ / 2)) * window[None, :]
    center = 2 * band[:, None]
    right = torch.flip(left, dims=(1,))
    band_pass = torch.cat([left, center, right], dim=1)
    return band_pass / (2 * band[:, None])


def forward(p: Params, x: torch.Tensor, kernel_size: int,
            sample_rate: int = 16000, stride: int = 1, dilation: int = 1,
            padding: str = "same", padding_mode: str = "reflect",
            min_low_hz: float = 50.0, min_band_hz: float = 50.0
            ) -> torch.Tensor:
    """x (B, T) or (B, T, Cin) → (B, T', out), float32. A grouped conv: one
    sinc filter bank shared across the input channels."""
    if x.ndim == 2:
        x = x[..., None]
    cin = x.shape[-1]
    filt = _filters(p, kernel_size, sample_rate, min_low_hz, min_band_hz)
    out_channels = filt.shape[0]
    if out_channels % cin != 0:
        raise ValueError("out_channels must be divisible by in_channels")
    x = x.float().transpose(1, 2)                   # (B, C, T)
    if padding == "same":
        # speechbrain's get_padding_elem: stride > 1 → k//2 each side;
        # stride 1 → dilation·(k-1)/2 each side
        lo = hi = (kernel_size // 2 if stride > 1
                   else dilation * (kernel_size - 1) // 2)
        x = F.pad(x, (lo, hi),
                  mode="reflect" if padding_mode == "reflect" else "constant")
    elif padding == "causal":
        x = F.pad(x, ((kernel_size - 1) * dilation, 0))
    elif padding != "valid":
        raise ValueError(f"unknown padding {padding!r}")
    y = F.conv1d(x, filt[:, None, :], stride=stride, dilation=dilation,
                 groups=cin)
    return y.transpose(1, 2)                        # (B, T', out)
