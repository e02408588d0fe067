"""MaskGCT's semantic codec as IndexTTS-2 uses it, channels-last.

Published description: amphion's ``models/codec/kmeans/repcodec_model.py``
(``RepCodec``), ``models/codec/amphion_codec/vocos.py``
(``VocosBackbone``, ``ConvNeXtBlock``) and
``models/codec/amphion_codec/quantize/factorized_vector_quantize.py``,
with IndexTTS-2's ``config.yaml`` ``semantic_codec`` sizes:

- ``quantize`` (the prompt's codes and their embeddings): the encoder, a
  Vocos backbone (Conv1d(1024, 384, 7) → LayerNorm → 12 ConvNeXt blocks →
  LayerNorm, every eps 1e-6) then Linear(384, 1024); then the one factorized
  quantizer: a 1 × 1 projection 1024 → 8, the nearest of 8192 codes by
  cosine (both sides L2-normalised, distance |e|² − 2e·c + |c|²), the code's
  raw embedding projected 8 → 1024. A ConvNeXt block: depthwise conv 7 →
  LayerNorm → Linear(384, 2048) → GELU → Linear(2048, 384) → ×γ → residual.
- ``vq2emb`` (the GPT's codes): the code's embedding projected 8 → 1024.

The quantizer's projections are weight-normed 1 × 1 convolutions; here they
are the linears they compute.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch import nn

Params = Dict[str, Any]


def _convnext(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = nn.conv1d(p["dw"], x, padding=3, groups=x.shape[-1])
    y = nn.layer_norm(p["norm"], y, eps=1e-6)
    y = nn.linear(p["pw2"], nn.gelu_exact(nn.linear(p["pw1"], y)))
    return x + p["gamma"].to(x.dtype) * y


def encode(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, T, 1024) → the encoder's output (B, T, 1024)."""
    h = nn.layer_norm(p["norm"], nn.conv1d(p["embed"], x, padding=3),
                      eps=1e-6)
    for blk in p["blocks"]:
        h = _convnext(blk, h)
    return nn.linear(p["out"], nn.layer_norm(p["final_norm"], h, eps=1e-6))


def vq2emb(p: Params, codes: torch.Tensor) -> torch.Tensor:
    """Codes (B, T) → their embeddings (B, T, 1024)."""
    q = p["quantizer"]
    return nn.linear(q["out_project"], q["codebook"]["w"][codes])


def quantize(p: Params, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w2v-BERT features (B, T, 1024) → (the quantized embeddings
    (B, T, 1024), the codes (B, T))."""
    q = p["quantizer"]
    z = nn.linear(q["in_project"], encode(p, x))
    e = F.normalize(z.float(), dim=-1)
    c = F.normalize(q["codebook"]["w"].float(), dim=-1)
    dist = (e.square().sum(-1, keepdim=True) - 2.0 * e @ c.T
            + c.square().sum(-1)[None, None])
    codes = torch.argmax(-dist, dim=-1)
    return vq2emb(p, codes), codes
