"""w2v-BERT 2.0's speech encoder up to the hidden state IndexTTS-2 reads,
channels-last ``(B, T, C)``.

Published description: transformers' ``Wav2Vec2BertModel``
(``models/wav2vec2_bert/modeling_wav2vec2_bert.py``) with
``facebook/w2v-bert-2.0``'s config.json:

- feature projection: LayerNorm(160) → Linear(160, 1024);
- each conformer layer: ``x + ½·FFN₁(LN(x))``, then relative-key
  self-attention ``x + Attn(LN(x))``, then the convolution module
  ``x + Conv(x)``, then ``x + ½·FFN₂(LN(x))``, then a final LayerNorm.
  FFN: Linear(1024, 4096) → swish → Linear(4096, 1024). Attention: q, k, v
  and out with bias, 16 heads of 64, scores ``q·k/√64`` plus
  ``q·E[clamp(j − i, −64, 8) + 64]/√64`` with E the 73 × 64 distance
  embedding. Conv module: LN → pointwise 1024 → 2048 (no bias) → GLU →
  causal depthwise conv 31 (left-padded by 30, no bias) → LN → swish →
  pointwise (no bias).

IndexTTS-2 (``infer_v2.py`` ``get_emb``) reads ``hidden_states[17]``, the
output of the first 17 layers, and normalises it by the checkpoint's
``wav2vec2bert_stats.pt`` (mean and std over channels): ``encode`` runs
only those layers, since nothing reads the last seven. Every LayerNorm's
eps is 1e-5. A prompt is one unpadded row, so the source's padding masks
are all true and left out.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.config import W2VBertConfig

Params = Dict[str, Any]


def _ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    return nn.linear(p["out"], nn.silu(nn.linear(p["inter"], x)))


def attention(p: Params, cfg: W2VBertConfig, x: torch.Tensor
              ) -> torch.Tensor:
    """Relative-key self-attention over x (B, T, C)."""
    b, t, d = x.shape
    dh = d // cfg.heads
    q, k, v = (nn.split_heads(nn.linear(p[n], x), cfg.heads)
               for n in ("q", "k", "v"))
    pos = torch.arange(t, device=x.device)
    dist = (pos[None, :] - pos[:, None]).clamp(-cfg.left_max_position,
                                               cfg.right_max_position)
    emb = p["distance"]["w"][dist + cfg.left_max_position].to(x.dtype)
    scores = torch.matmul(q, k.transpose(-1, -2))
    scores = (scores + torch.einsum("bhld,lrd->bhlr", q, emb)) \
        / math.sqrt(dh)
    w = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return nn.linear(p["o"], nn.merge_heads(torch.matmul(w, v)))


def conv_module(p: Params, cfg: W2VBertConfig, x: torch.Tensor
                ) -> torch.Tensor:
    h = nn.layer_norm(p["ln"], x, eps=cfg.eps)
    h = nn.glu(nn.conv1d(p["pw1"], h))
    h = nn.conv1d(p["dw"], h, padding=(cfg.conv_kernel - 1, 0),
                  groups=h.shape[-1])
    h = nn.silu(nn.layer_norm(p["dw_ln"], h, eps=cfg.eps))
    return nn.conv1d(p["pw2"], h)


def layer(p: Params, cfg: W2VBertConfig, x: torch.Tensor) -> torch.Tensor:
    eps = cfg.eps
    x = x + 0.5 * _ffn(p["ffn1"], nn.layer_norm(p["ffn1_ln"], x, eps=eps))
    x = x + attention(p["attn"], cfg, nn.layer_norm(p["attn_ln"], x,
                                                    eps=eps))
    x = x + conv_module(p["conv"], cfg, x)
    x = x + 0.5 * _ffn(p["ffn2"], nn.layer_norm(p["ffn2_ln"], x, eps=eps))
    return nn.layer_norm(p["final_ln"], x, eps=eps)


def encode(params: Params, cfg: W2VBertConfig, feats: torch.Tensor
           ) -> torch.Tensor:
    """One prompt's stacked fbank rows (T, 160) → hidden state
    ``cfg.out_layer`` (1, T, 1024), normalised by the encoder's stats
    (``params["stats"]``)."""
    x = nn.linear(params["proj"], nn.layer_norm(params["proj_ln"],
                                                feats[None], eps=cfg.eps))
    for blk in params["layers"][: cfg.out_layer]:
        x = layer(blk, cfg, x)
    st = params["stats"]
    return (x - st["mean"].to(x.dtype)) / st["std"].to(x.dtype)
