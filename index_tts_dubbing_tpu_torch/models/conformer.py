"""Conformer encoder (wenet-style), the speaker-conditioning frontend.

Counterpart of the JAX package's ``models/conformer.py``: conv2d2
subsampling, rel-pos MHA without rel_shift, SiLU, no macaron, conv module
kernel 15, normalize_before, inference only.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from index_tts_dubbing_tpu_torch import nn

Params = Dict[str, Any]


def sinusoidal_pos(max_len: int, d_model: int) -> np.ndarray:
    """wenet PositionalEncoding table, (max_len, d)."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def conv2d_subsample2(p: Params, x: torch.Tensor, mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conv2d(1→odim, k3, s2) → ReLU → linear over (odim · freq').
    x (B, T, F) → (B, T', odim); mask (B, T) → (B, T') via [2::2]."""
    h = torch.relu(nn.conv2d(p["conv"], x[..., None], stride=(2, 2)))
    b, t2, f2, c = h.shape
    # channel-major flatten, as torch's view(b, t, c*f) after transpose
    h = h.permute(0, 1, 3, 2).reshape(b, t2, c * f2)
    return nn.linear(p["out"], h), mask[:, 2::2]


def rel_pos_mha(p: Params, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: torch.Tensor, heads: int) -> torch.Tensor:
    """Transformer-XL style rel-pos MHA, rel_shift disabled.
    mask (B, 1, T) True=keep."""
    b, t, d = x.shape
    dk = d // heads
    q = nn.split_heads(nn.linear(p["q"], x), heads)
    k = nn.split_heads(nn.linear(p["k"], x), heads)
    v = nn.split_heads(nn.linear(p["v"], x), heads)
    pp = nn.split_heads(nn.linear(p["pos"], pos_emb), heads)  # (1,H,T,dk)
    qu = q + p["pos_bias_u"][None, :, None, :]
    qv = q + p["pos_bias_v"][None, :, None, :]
    ac = torch.matmul(qu.float(), k.float().transpose(-1, -2))
    bd = torch.matmul(qv.float(), pp.expand_as(k).float().transpose(-1, -2))
    scores = (ac + bd) / math.sqrt(dk)
    m = mask[:, None, :, :]                              # (B,1,1,T)
    scores = torch.where(m, scores, torch.tensor(float("-inf"),
                                                 device=x.device))
    attn = torch.softmax(scores, dim=-1)
    attn = torch.where(m, attn, torch.zeros((), device=x.device)).to(x.dtype)
    out = torch.matmul(attn, v)
    return nn.linear(p["out"], nn.merge_heads(out))


def conv_module(p: Params, x: torch.Tensor, mask_pad: torch.Tensor,
                kernel: int = 15) -> torch.Tensor:
    """pointwise → GLU → depthwise k15 → LayerNorm → SiLU → pointwise,
    with pad masking."""
    keep = mask_pad[:, :, None]
    x = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
    x = nn.glu(nn.conv1d(p["pw1"], x))
    x = nn.conv1d(p["dw"], x, padding=(kernel - 1) // 2, groups=x.shape[-1])
    x = nn.silu(nn.layer_norm(p["ln"], x))
    x = nn.conv1d(p["pw2"], x)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def encoder_layer(p: Params, x: torch.Tensor, pos_emb: torch.Tensor,
                  mask: torch.Tensor, mask_pad: torch.Tensor,
                  heads: int) -> torch.Tensor:
    x = x + rel_pos_mha(p["attn"], nn.layer_norm(p["norm_mha"], x),
                        pos_emb, mask, heads)
    x = x + conv_module(p["conv"], nn.layer_norm(p["norm_conv"], x), mask_pad)
    h = nn.layer_norm(p["norm_ff"], x)
    x = x + nn.linear(p["ff"]["w2"], nn.silu(nn.linear(p["ff"]["w1"], h)))
    return nn.layer_norm(p["norm_final"], x)


def forward(params: Params, mel: torch.Tensor, lengths: torch.Tensor,
            heads: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """mel (B, T, n_mels), lengths (B,) → ((B, T', d), keep-mask (B, T'))."""
    keep = ~nn.make_pad_mask(lengths, mel.shape[1])
    x, keep = conv2d_subsample2(params["embed"], mel, keep)
    x = x * math.sqrt(x.shape[-1])
    pos_emb = params["pe"][None, :x.shape[1], :].to(x.dtype)
    mask = keep[:, None, :]
    for blk in params["blocks"]:
        x = encoder_layer(blk, x, pos_emb, mask, keep, heads)
    return nn.layer_norm(params["after_norm"], x), keep
