"""F5-TTS's DiT backbone (``F5TTS_Base``), channels-last ``(B, N, C)``.

Plain functions over the parameter tree that ``weights.init_dit`` draws
(linear kernels ``(Cin, Cout)``, conv1d kernels ``(K, Cin/groups, Cout)``,
as everywhere in the port). Published description: F5-TTS's
``model/backbones/dit.py`` and ``model/modules.py``:

- text: ``Embedding(V + 1, T)`` over the character ids shifted by one (0
  is the filler, which pads every row to its frame count), plus the
  sinusoidal absolute position (cos | sin halves, ``precompute_freqs_cis``),
  then ``conv_layers`` ConvNeXt-V2 blocks, each a residual of depthwise
  conv k 7 → LayerNorm (eps 1e-6) → Linear(T, 2T) → GELU → GRN →
  Linear(2T, T). A row's text is encoded at its own length (GRN's norm runs
  over time), as F5's ``get_input_embed`` does for a batch with a mask;
- input: ``Linear(2M + T, D)`` over ``[x_t, cond, text]`` plus a residual
  convolutional position embedding (two grouped Conv1d(D, D, 31) with Mish;
  F5 zeroes padded positions before the first conv and after the second,
  and here they are zeroed between the two as well, so that a row padded in
  a batch gives what it gives alone: in F5's batch the first conv's output
  at the padding reaches the last 15 frames of a shorter row);
- time: a sinusoidal embedding of 256 (scale 1000) → Linear → SiLU →
  Linear;
- blocks: adaLN-zero. ``Linear(D, 6D)`` over SiLU(t) gives the shift,
  scale and gate of attention and feed-forward (in that order); each
  sublayer reads ``LN(x)·(1 + scale) + shift`` (LayerNorm without affine,
  eps 1e-6) and adds ``gate·out``. Attention: q, k, v with bias, rotary
  (x-transformers, interleaved pairs, dim 64) on the first
  ``pe_attn_head`` heads only, padded keys masked and padded outputs
  zeroed; feed-forward Linear(D, 2D) → GELU(tanh) → Linear(2D, D);
- out: a final adaLN (scale, shift) → Linear(D, M).

Precision, where the published code leaves it to the caller's dtype:
matmuls, convolutions, attention and the activations run in the
parameters' dtype; LayerNorm with its modulation, GRN's norm, the rotary
and the residual stream run in float32 (F5 casts its whole model to half
precision, residual included). Everything else follows the published
description.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.config import DiTConfig

Params = Dict[str, Any]


def valid_mask(lens: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) True at each row's first ``lens[b]`` positions."""
    return torch.arange(n, device=lens.device)[None, :] < lens[:, None]


def modulated_ln(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 dtype) -> torch.Tensor:
    """``LN(x)·(1 + scale) + shift`` (LayerNorm without affine, eps 1e-6)
    over x (B, N, D) float32, in ``dtype``; scale and shift (1, D), the
    one time every row shares, as the LayerNorm's weight and bias."""
    y = F.layer_norm(x, x.shape[-1:], 1.0 + scale[0], shift[0], eps=1e-6)
    return y.to(dtype)


# -- text ---------------------------------------------------------------
def text_positions(dim: int, n: int, device, theta: float = 10000.0
                   ) -> torch.Tensor:
    """``precompute_freqs_cis(dim, n)``: (n, dim) float32, cos | sin."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device)
                             [: dim // 2].float() / dim))
    ang = torch.outer(torch.arange(n, device=device).float(), freqs)
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _convnext(p: Params, x: torch.Tensor, valid: torch.Tensor
              ) -> torch.Tensor:
    """One ConvNeXt-V2 block over (B, N, T); positions past a row's length
    read as the zero padding of that row alone."""
    keep = valid[..., None]
    y = nn.conv1d(p["dw"], x.masked_fill(~keep, 0.0), padding=3,
                  groups=x.shape[-1])
    y = nn.layer_norm(p["norm"], y, eps=1e-6)
    y = F.gelu(nn.linear(p["pw1"], y))
    yf = y.float().masked_fill(~keep, 0.0)
    gx = yf.square().sum(dim=1, keepdim=True).sqrt()        # over time
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    y = (p["grn"]["gamma"].float() * (yf * nx) + p["grn"]["beta"].float()
         + yf).to(x.dtype)
    return x + nn.linear(p["pw2"], y)


def text_encoder(p: Params, cfg: DiTConfig, ids: torch.Tensor,
                 lens: torch.Tensor, dtype) -> torch.Tensor:
    """ids (B, N): character ids already shifted by one, filler 0 past the
    text; lens (B,): each row's frames. → (B, N, T) in ``dtype``, zero past
    each row's length (F5's per-row encoding, padded with zeros)."""
    n = ids.shape[1]
    valid = valid_mask(lens, n)
    x = nn.embedding(p["emb"], ids).to(dtype)
    pos = torch.clamp(torch.arange(n, device=ids.device),
                      max=cfg.text_max_pos - 1)
    x = (x.float() + text_positions(cfg.text_dim, cfg.text_max_pos,
                                    ids.device)[pos]).to(dtype)
    for blk in p["blocks"]:
        x = _convnext(blk, x, valid)
    return x.masked_fill(~valid[..., None], 0.0)


# -- time ----------------------------------------------------------------
def sinus_time(t: torch.Tensor, dim: int, scale: float = 1000.0
               ) -> torch.Tensor:
    """``SinusPositionEmbedding``: t (B,) → (B, dim) float32, sin | cos."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    emb = torch.exp(torch.arange(half, device=t.device).float() * -emb)
    emb = scale * t.float()[:, None] * emb[None, :]
    return torch.cat([emb.sin(), emb.cos()], dim=-1)


def time_embed(p: Params, cfg: DiTConfig, t: torch.Tensor, dtype
               ) -> torch.Tensor:
    """t (S,) → (S, D) in ``dtype``."""
    h = nn.linear(p["l1"], sinus_time(t, cfg.time_freq_dim).to(dtype))
    return nn.linear(p["l2"], nn.silu(h))


def modulations(params: Params, temb: torch.Tensor
                ) -> Tuple[list, torch.Tensor]:
    """Every adaLN's (shift, scale, gate, ...) rows for the time
    embeddings ``temb`` (S, D): per block (S, 6D) and the final (S, 2D),
    float32."""
    st = nn.silu(temb)
    return ([nn.linear(b["mod"], st).float() for b in params["blocks"]],
            nn.linear(params["final"]["mod"], st).float())


# -- input ---------------------------------------------------------------
def input_embed(p: Params, x: torch.Tensor, cond: torch.Tensor,
                text: torch.Tensor, valid: Optional[torch.Tensor],
                dtype) -> torch.Tensor:
    """[x, cond, text] → (B, N, D) float32: the projection plus the
    convolutional position embedding."""
    h = nn.linear(p["proj"], torch.cat([x.to(dtype), cond.to(dtype),
                                        text.to(dtype)], dim=-1))
    keep = None if valid is None else valid[..., None]
    pad = (lambda v: v) if keep is None else (
        lambda v: v.masked_fill(~keep, 0.0))
    k = p["conv1"]["w"].shape[0]
    g = h.shape[-1] // p["conv1"]["w"].shape[1]
    c = pad(F.mish(nn.conv1d(p["conv1"], pad(h), padding=k // 2, groups=g)))
    c = pad(F.mish(nn.conv1d(p["conv2"], c, padding=k // 2, groups=g)))
    return (c + h).float()


# -- blocks --------------------------------------------------------------
def rotary(n: int, dim: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """x-transformers' ``RotaryEmbedding(dim)`` at positions 0..n-1: cos
    and sin (n, dim), each frequency twice in a row."""
    inv = 1.0 / (10000 ** (torch.arange(0, dim, 2, device=device).float()
                           / dim))
    f = torch.outer(torch.arange(n, device=device).float(), inv)
    f = torch.stack([f, f], dim=-1).reshape(n, dim)
    return f.cos(), f.sin()


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """x (..., n, dim) in float32: x·cos + rotate_half(x)·sin, pairs
    interleaved."""
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(
        x.shape)
    return x * cos + rot * sin


def attention(p: Params, cfg: DiTConfig, h: torch.Tensor,
              valid: Optional[torch.Tensor],
              rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """h (B, N, D) in the compute dtype → (B, N, D): bidirectional, rotary
    on the first ``pe_attn_head`` heads, padded keys masked and padded
    outputs zeroed."""
    b, n, _ = h.shape
    shape = (b, n, cfg.heads, cfg.dim_head)
    q = nn.linear(p["q"], h).view(shape)
    k = nn.linear(p["k"], h).view(shape)
    v = nn.linear(p["v"], h).view(shape)
    pn = cfg.pe_attn_head
    cos, sin = rope
    for t in (q, k):
        r = t[:, :, :pn].transpose(1, 2).float()             # (B, pn, N, d)
        t[:, :, :pn] = apply_rotary(r, cos, sin).transpose(1, 2).to(t.dtype)
    mask = None if valid is None else valid[:, None, None, :]
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), attn_mask=mask)
    o = nn.linear(p["o"], o.transpose(1, 2).reshape(b, n, -1))
    if valid is not None:
        o = o.masked_fill(~valid[..., None], 0.0)
    return o


def block(p: Params, cfg: DiTConfig, x: torch.Tensor, mod: torch.Tensor,
          valid: Optional[torch.Tensor],
          rope: Tuple[torch.Tensor, torch.Tensor], dtype) -> torch.Tensor:
    """One adaLN-zero block: x (B, N, D) float32, mod (1, 6D) float32 →
    x."""
    sh_a, sc_a, g_a, sh_f, sc_f, g_f = mod.chunk(6, dim=-1)
    h = modulated_ln(x, sc_a, sh_a, dtype)
    x = torch.addcmul(x, g_a[:, None], attention(p, cfg, h, valid, rope))
    h = modulated_ln(x, sc_f, sh_f, dtype)
    h = nn.linear(p["ff2"], F.gelu(nn.linear(p["ff1"], h),
                                   approximate="tanh"))
    return torch.addcmul(x, g_f[:, None], h)


def forward(params: Params, cfg: DiTConfig, x: torch.Tensor,
            cond: torch.Tensor, text: torch.Tensor,
            mods: Tuple[list, torch.Tensor], valid: Optional[torch.Tensor],
            rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> torch.Tensor:
    """One DiT forward: x and cond (B, N, M), the encoded text (B, N, T),
    ``mods`` from ``modulations`` for this step (each (1, ·)),
    ``valid`` (B, N) or None → the velocity (B, N, M), float32. The
    compute dtype is the parameters'."""
    dtype = params["final"]["proj"]["w"].dtype
    n = x.shape[1]
    rope = rope if rope is not None else rotary(n, cfg.dim_head, x.device)
    h = input_embed(params["input"], x, cond, text, valid, dtype)
    block_mods, final_mod = mods
    for p, mod in zip(params["blocks"], block_mods):
        h = block(p, cfg, h, mod, valid, rope, dtype)
    scale, shift = final_mod.chunk(2, dim=-1)
    return nn.linear(params["final"]["proj"],
                     modulated_ln(h, scale, shift, dtype)).float()
