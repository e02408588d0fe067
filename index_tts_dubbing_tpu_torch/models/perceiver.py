"""Perceiver resampler: compresses the conformer output to 32 latent
conditioning vectors. Counterpart of the JAX package's
``models/perceiver.py`` (queries included in the KV stream, GEGLU
feed-forward, L2-normalising RMSNorm head)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from index_tts_dubbing_tpu_torch import nn

Params = Dict[str, Any]


def _attention(p: Params, latents: torch.Tensor, ctx: torch.Tensor,
               mask: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    full_ctx = torch.cat([latents, ctx], dim=1)
    q = nn.split_heads(nn.linear(p["to_q"], latents), heads)
    k, v = nn.linear(p["to_kv"], full_ctx).chunk(2, dim=-1)
    k, v = nn.split_heads(k, heads), nn.split_heads(v, heads)
    m = None if mask is None else mask[:, None, None, :]
    out = nn.mha(q, k, v, mask=m)
    return nn.linear(p["to_out"], nn.merge_heads(out))


def _geglu_ff(p: Params, x: torch.Tensor) -> torch.Tensor:
    a, gate = nn.linear(p["w1"], x).chunk(2, dim=-1)
    return nn.linear(p["w2"], nn.gelu_exact(gate) * a)


def forward(params: Params, ctx: torch.Tensor,
            mask: Optional[torch.Tensor] = None, heads: int = 8) -> torch.Tensor:
    """ctx (B, T, dim_context), mask (B, 32+T) → (B, num_latents, dim)."""
    ctx = nn.linear(params["proj_context"], ctx)
    lat = params["latents"]
    latents = lat[None].expand((ctx.shape[0],) + lat.shape).to(ctx.dtype)
    for layer in params["layers"]:
        latents = _attention(layer["attn"], latents, ctx, mask, heads) + latents
        latents = _geglu_ff(layer["ff"], latents) + latents
    return nn.rms_norm_l2(params["norm"], latents)
