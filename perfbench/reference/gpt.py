"""UnifiedVoice (IndexTTS's GPT-2 over [cond(32) · text · mel-code]) in
plain PyTorch, full-sequence only: no KV cache, no beams, no buckets.

- ``conditioning``: log-mel → conformer → perceiver → 32 latents;
- ``decode_logits``: the logits that decoding saw before each served code,
  from one causal pass over the prompt and the served codes (teacher
  forcing). The prefix is [cond][start_text, text, stop_text][start_mel]
  with text positions from 0, and served code k (from 0) enters at mel
  position k + 2: the tortoise off-by-one the checkpoints were trained with;
- ``latents``: the teacher-forced latent pass over [cond][start_text, text,
  stop_text][start_mel, codes, stop_mel] at ordinary positions, whose first
  ``len(codes)`` mel positions feed the vocoder.

The block equations follow GPT-2 (pre-norm, fused qkv, gelu_pytorch_tanh
MLP of width 4·d), with attention scores and softmax in float32.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from perfbench.reference import conformer, nn, perceiver

Params = Dict[str, Any]
_NEG = -1e30


def _act(g: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    act = g["activation"]
    return nn.gelu_tanh(x) if ("tanh" in act or act == "gelu_new") \
        else nn.gelu_exact(x)


def trunk(p: Params, g: Dict[str, Any], emb: torch.Tensor) -> torch.Tensor:
    """Embeddings (B, T, C) → hidden after ln_f, causal attention."""
    t = emb.shape[1]
    heads = g["heads"]
    scale = 1.0 / math.sqrt(g["model_dim"] // heads)
    keep = torch.ones((t, t), dtype=torch.bool, device=emb.device).tril()
    bias = torch.where(keep, 0.0, _NEG).to(torch.float32)[None, None]
    x = emb
    for blk in p["blocks"]:
        q, k, v = nn.linear(blk["attn"]["qkv"],
                            nn.layer_norm(blk["ln1"], x)).chunk(3, dim=-1)
        q, k, v = (nn.split_heads(z, heads) for z in (q, k, v))
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        w = torch.softmax(s + bias, dim=-1).to(v.dtype)
        x = x + nn.linear(blk["attn"]["proj"],
                          nn.merge_heads(torch.matmul(w, v)))
        h = nn.layer_norm(blk["ln2"], x)
        x = x + nn.linear(blk["mlp"]["proj"],
                          _act(g, nn.linear(blk["mlp"]["fc"], h)))
    return nn.layer_norm(p["ln_f"], x)


def conditioning(p: Params, g: Dict[str, Any], mel: torch.Tensor
                 ) -> torch.Tensor:
    """mel (1, T, n_mels) → conds (1, 32, model_dim)."""
    lengths = torch.tensor([mel.shape[1]], device=mel.device)
    x, keep = conformer.forward(p["cond_encoder"], mel, lengths,
                                heads=g["cond_attention_heads"])
    ones = torch.ones((keep.shape[0], g["condition_num_latent"]),
                      dtype=torch.bool, device=keep.device)
    return perceiver.forward(p["perceiver"], x, torch.cat([ones, keep], 1),
                             heads=g["cond_attention_heads"])


def _text_emb(p: Params, g: Dict[str, Any], text: torch.Tensor
              ) -> torch.Tensor:
    framed = torch.cat([text.new_tensor([g["start_text_token"]]), text,
                        text.new_tensor([g["stop_text_token"]])])
    pos = torch.arange(framed.numel(), device=text.device)
    return nn.embedding(p["text_emb"], framed) + p["text_pos"]["w"][pos]


def _mel_head(p: Params, h: torch.Tensor) -> torch.Tensor:
    return nn.linear(p["mel_head"], nn.layer_norm(p["final_norm"], h))


def decode_logits(p: Params, g: Dict[str, Any], conds: torch.Tensor,
                  text: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """conds (1, 32, C), text ids (L,), served codes (n,) → logits (n, V):
    row k is what the decoder saw before choosing codes[k]."""
    dtype = p["mel_emb"]["w"].dtype
    n = codes.numel()
    start = (p["mel_emb"]["w"][g["start_mel_token"]]
             + p["mel_pos"]["w"][0])[None]
    fed = (p["mel_emb"]["w"][codes[: n - 1]]
           + p["mel_pos"]["w"][2: n + 1])
    emb = torch.cat([conds[0].to(dtype), _text_emb(p, g, text).to(dtype),
                     start.to(dtype), fed.to(dtype)])[None]
    h = trunk(p, g, emb)[0, -n:]
    return _mel_head(p, h).float()


def latents(p: Params, g: Dict[str, Any], conds: torch.Tensor,
            text: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """conds (1, 32, C), text ids (L,), trimmed codes (n,) → the latent
    frames (n, C) that the vocoder reads."""
    dtype = p["mel_emb"]["w"].dtype
    n = codes.numel()
    mel = torch.cat([codes.new_tensor([g["start_mel_token"]]), codes,
                     codes.new_tensor([g["stop_mel_token"]])])
    mel_e = (nn.embedding(p["mel_emb"], mel)
             + p["mel_pos"]["w"][torch.arange(n + 2, device=codes.device)])
    emb = torch.cat([conds[0].to(dtype), _text_emb(p, g, text).to(dtype),
                     mel_e.to(dtype)])[None]
    h = trunk(p, g, emb)
    enc = nn.layer_norm(p["final_norm"], h[0, -(n + 2):])
    return enc[:n]
