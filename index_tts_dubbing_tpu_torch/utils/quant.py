"""Weight-only int8 quantization for the AR decode path.

Counterpart of the JAX package's ``utils/quant.py``, with its numpy ops one
for one in torch, so the port quantises on the weights' own device; the
results equal the JAX module's bit for bit (IEEE float32 division, round
half to even). Per-output-channel symmetric int8: W ≈ W_q · scale[None, :]
with scale = max|W[:, n]| / 127. Kept weight-only (activations stay in the
compute dtype), so the decode step streams half the weight bytes of bf16.

The quantized form is a drop-in param dict {"w_q": int8 (K, N),
"scale": float32 (N,), "b": ...} recognised by ``nn.linear``; only the GPT
trunk's big matmuls (qkv/proj/fc/proj, mel_head) are converted: layer norms,
biases, embeddings and position tables stay in full precision.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def quantize_linear_int8(p: Params) -> Params:
    """{"w": (K, N), "b"?} → {"w_q", "scale", "b"?}. No-op if already
    quantized."""
    if "w_q" in p:
        return p
    w = p["w"].float()
    scale = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)
    w_q = torch.clamp(torch.round(w / scale[None, :]), -127, 127
                      ).to(torch.int8)
    out = {"w_q": w_q, "scale": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_gpt_int8(gpt_params: Params) -> Params:
    """Quantize the trunk matmuls + mel head of a UnifiedVoice param tree
    (the port's list of blocks: each block's matmuls are quantised as JAX's
    stacked trunk quantises that layer). Returns a new tree; non-matmul
    leaves are shared."""
    out = dict(gpt_params)
    out["blocks"] = [
        dict(blk,
             attn={name: quantize_linear_int8(blk["attn"][name])
                   for name in ("qkv", "proj")},
             mlp={name: quantize_linear_int8(blk["mlp"][name])
                  for name in ("fc", "proj")})
        for blk in gpt_params["blocks"]]
    out["mel_head"] = quantize_linear_int8(gpt_params["mel_head"])
    return out
