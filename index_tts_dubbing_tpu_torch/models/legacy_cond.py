"""Legacy (IndexTTS-1.0) conditioning encoder: Conv1d + tortoise-style QKV
attention blocks over the reference mel.

Counterpart of the JAX package's ``models/legacy_cond.py``. Behavioural
spec: the reference's gpt/model.py:210-235 (ConditioningEncoder) +
utils/arch_util.py (AttentionBlock:77, QKVAttentionLegacy:41, GroupNorm32)
+ the reachable slice of utils/xtransformers.py (RelativePositionBias:146-188).
Scores and softmax in float32; the value product in the input's dtype.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from index_tts_dubbing_tpu_torch import nn

Params = Dict[str, Any]


def norm_groups(channels: int) -> int:
    """normalization() group choice (arch_util.py:23-37)."""
    groups = 32
    if channels <= 16:
        groups = 8
    elif channels <= 64:
        groups = 16
    while channels % groups != 0:
        groups = int(groups / 2)
    if groups <= 2:
        raise ValueError(f"no group count > 2 divides {channels} channels")
    return groups


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 64) -> torch.Tensor:
    """Non-causal T5-style bucketing (xtransformers.py:157-173)."""
    n = -rel_pos
    num_buckets //= 2
    ret = (n < 0).to(torch.int32) * num_buckets
    n = n.abs()
    max_exact = num_buckets // 2
    val_if_large = max_exact + (
        torch.log(torch.clamp(n, min=1).float() / max_exact)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n.to(torch.int32), val_if_large)


def relative_position_bias(p: Params, t: int, scale: float,
                           num_buckets: int = 32,
                           max_distance: int = 64) -> torch.Tensor:
    """(1, H, T, T) additive bias (xtransformers.py:177-188)."""
    pos = torch.arange(t, device=p["emb"]["w"].device)
    bucket = relative_position_bucket(pos[None, :] - pos[:, None],
                                      num_buckets, max_distance)
    values = p["emb"]["w"][bucket.long()]                 # (T, T, H)
    return values.permute(2, 0, 1)[None] * scale


def attention_block(p: Params, x: torch.Tensor, heads: int,
                    rel_pos: Optional[Params] = None) -> torch.Tensor:
    """Tortoise AttentionBlock (arch_util.py:77-120). x (B, T, C)."""
    c = x.shape[-1]
    h = nn.group_norm(p["norm"], x, groups=norm_groups(c))
    qkv = nn.conv1d(p["qkv"], h)                          # (B, T, 3C)
    b, t, _ = qkv.shape
    ch = c // heads
    # legacy layout: width = H * 3 * ch, per-head [q, k, v] chunks
    qkv = qkv.reshape(b, t, heads, 3 * ch).transpose(1, 2)
    q, k, v = qkv.split(ch, dim=-1)
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    w = torch.matmul((q * scale).float(), (k * scale).float().transpose(-1, -2))
    if rel_pos is not None:
        w = w + relative_position_bias(rel_pos, t, scale=ch ** 0.5)
    w = torch.softmax(w, dim=-1).to(x.dtype)
    a = torch.matmul(w, v).transpose(1, 2).reshape(b, t, c)
    return x + nn.conv1d(p["proj"], a)


def forward(params: Params, mel: torch.Tensor, heads: int,
            mean: bool = False) -> torch.Tensor:
    """mel (B, T, n_mels) → (B, T, C) or (B, C) when mean.
    Mirrors ConditioningEncoder.forward (gpt/model.py:228-235)."""
    x = nn.conv1d(params["init"], mel)
    for blk in params["blocks"]:
        x = attention_block(blk, x, heads, blk.get("rel_pos"))
    if mean:
        return x.mean(dim=1)
    return x


def init(r, spec_dim: int = 100, embedding_dim: int = 1024,
         attn_blocks: int = 6, heads: int = 16) -> Params:
    """Random weights from ``r`` (a ``weights.Init``) with the JAX init's
    tree and distributions: each block's ``proj`` is zero, so a block
    starts as the identity (``heads`` shapes nothing: no ``rel_pos``)."""
    d = embedding_dim
    return {"init": r.conv1d(spec_dim, d, 1),
            "blocks": [{"norm": {"g": r.ones(d), "b": r.zeros(d)},
                        "qkv": r.conv1d(d, 3 * d, 1),
                        "proj": {"w": torch.zeros((1, d, d), device=r.device),
                                 "b": r.zeros(d)}}
                       for _ in range(attn_blocks)]}
