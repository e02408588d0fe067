"""ECAPA-TDNN speaker encoder, inference only (batch norms use running
statistics). Counterpart of the JAX package's ``models/ecapa.py``;
activations are (B, T, C)."""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch import nn

Params = Dict[str, Any]

CHANNELS = [512, 512, 512, 512, 1536]
KERNELS = [5, 3, 3, 3, 1]
DILATIONS = [1, 2, 3, 4, 1]
RES2NET_SCALE = 8
SE_CHANNELS = 128
ATTENTION_CHANNELS = 128


def _conv_same(p: Params, x: torch.Tensor, k: int, dilation: int = 1) -> torch.Tensor:
    """speechbrain 'same' conv: reflect-pad floor(d*(k-1)/2) on both sides."""
    pad = (dilation * (k - 1)) // 2
    if pad:
        x = F.pad(x.transpose(1, 2), (pad, pad), mode="reflect").transpose(1, 2)
    return nn.conv1d(p, x, dilation=dilation)


def _tdnn_block(p: Params, x: torch.Tensor, k: int, dilation: int) -> torch.Tensor:
    """Conv → ReLU → BatchNorm."""
    return nn.batch_norm(p["bn"], torch.relu(_conv_same(p["conv"], x, k, dilation)))


def _res2net_block(p: Params, x: torch.Tensor, scale: int, k: int,
                   dilation: int) -> torch.Tensor:
    chunks = x.chunk(scale, dim=-1)
    ys: List[torch.Tensor] = [chunks[0]]
    y_prev = None
    for i in range(1, scale):
        inp = chunks[i] if i == 1 else chunks[i] + y_prev
        y_prev = _tdnn_block(p["blocks"][i - 1], inp, k, dilation)
        ys.append(y_prev)
    return torch.cat(ys, dim=-1)


def _se_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    s = x.mean(dim=1, keepdim=True)
    s = torch.relu(nn.conv1d(p["conv1"], s))
    return torch.sigmoid(nn.conv1d(p["conv2"], s)) * x


def _se_res2net_block(p: Params, x: torch.Tensor, k: int, dilation: int) -> torch.Tensor:
    residual = x
    x = _tdnn_block(p["tdnn1"], x, 1, 1)
    x = _res2net_block(p["res2net"], x, RES2NET_SCALE, k, dilation)
    x = _tdnn_block(p["tdnn2"], x, 1, 1)
    return _se_block(p["se"], x) + residual


def _asp(p: Params, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Attentive statistics pooling with global context: (B, T, C) → (B, 1, 2C)."""
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).square().mean(dim=1, keepdim=True)
    std = torch.clamp(var, min=eps).sqrt()
    attn_in = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
    a = _tdnn_block(p["tdnn"], attn_in, 1, 1)
    a = nn.conv1d(p["conv"], torch.tanh(a))
    w = torch.softmax(a.float(), dim=1).to(x.dtype)
    mean2 = (w * x).sum(dim=1, keepdim=True)
    var2 = (w * (x - mean2).square()).sum(dim=1, keepdim=True)
    std2 = torch.clamp(var2, min=eps).sqrt()
    return torch.cat([mean2, std2], dim=-1)


def forward(params: Params, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, n_mels) → speaker embedding (B, 1, lin_neurons)."""
    x = _tdnn_block(params["blocks"][0], mel, KERNELS[0], DILATIONS[0])
    feats = []
    for i in range(1, len(CHANNELS) - 1):
        x = _se_res2net_block(params["blocks"][i], x, KERNELS[i], DILATIONS[i])
        feats.append(x)
    x = _tdnn_block(params["mfa"], torch.cat(feats, dim=-1), KERNELS[-1],
                    DILATIONS[-1])
    x = nn.batch_norm(params["asp_bn"], _asp(params["asp"], x))
    return nn.conv1d(params["fc"], x)
