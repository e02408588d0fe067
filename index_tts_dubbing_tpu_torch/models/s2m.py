"""IndexTTS-2's semantic-to-mel stage (S2M), channels-last ``(B, N, C)``.

Published description: index-tts's ``indextts/s2mel/modules/``
(``commons.MyModel``, ``length_regulator.InterpolateRegulator``,
``flow_matching.CFM``, ``diffusion_transformer.DiT``, ``gpt_fast/model.py``
and ``wavenet.WN``, from seed-vc), with ``config.yaml``'s ``s2mel``:

- ``gpt_layer``: three linears 1280 → 256 → 128 → 1024, no activation;
- the length regulator: Linear(1024, 512) over the codes' features,
  nearest interpolation to the row's mel frames, four blocks of
  Conv1d(512, 512, 3, pad 1) → GroupNorm(1 group) → Mish, then
  Conv1d(512, 512, 1); frames past the row masked to zero;
- the DiT (one forward a guided Euler step): ``x_in = [x, prompt_x,
  cond_projection(mu), style]`` (80 + 80 + 512 + 192) → Linear(864, 512);
  13 gpt-fast blocks of 512 with 8 heads of 64, each
  ``h + Attn(AdaRMS(h))`` then ``h + SwiGLU(AdaRMS(h))``, AdaRMS being
  ``w·RMSNorm(h) + b`` (eps 1e-5, with the norm's own weight) with (w, b)
  a Linear(512, 1024) of the time embedding; attention q, k, v from one
  linear without bias, rotary on every head (pairs interleaved, base
  10 000), keys past a row's frames masked; SwiGLU ``w2(silu(w1 h)·w3 h)``
  of width 1536, no biases; U-ViT skips: the outputs of blocks 0-5 enter
  blocks 12-7 (last out, first in) through Linear(1024, 512) over
  ``[h, skip]``; a final AdaRMS; the long skip Linear(592, 512) over
  ``[h, x]``;
- the WaveNet head: Linear(512, 512); 8 layers of a weight-normed
  Conv1d(512, 1024, 5) (reflect-padded by 2, encodec's ``SConv1d``) plus
  the time embedding of the head's own ``TimestepEmbedder`` through a
  1 × 1 conv, gated ``tanh · sigmoid``, a 1 × 1 res-skip conv (the last
  layer skip only), the residual masked to the row; plus
  Linear(512, 512) of the long skip's output; the final layer: LayerNorm
  without affine, modulated by ``(shift, scale)`` = Linear(512, 1024) of
  SiLU(time), a Linear(512, 512), then Conv1d(512, 80, 1);
- time: a sinusoidal embedding of 256 (scale 1000, cos | sin) → Linear →
  SiLU → Linear, one for the transformer and one for the WaveNet head.

Precision: matmuls, convolutions and attention in the parameters' dtype;
the residual streams, RMSNorm and LayerNorm with their modulations, the
time path, the gating and everything outside the DiT's forward (the
regulator, ``gpt_layer``) in float32. Several rows of other lengths in one
padded batch give what each gives alone: keys past a row are masked, its
WaveNet convs reflect at its own end, and the regulator's convs and
GroupNorm see its own frames alone.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.config import S2MConfig

Params = Dict[str, Any]


def _lin(p: Params, x: torch.Tensor, dtype) -> torch.Tensor:
    """A linear in ``dtype``, back in float32."""
    return nn.linear(p, x.to(dtype)).float()


# -- before the sampler ---------------------------------------------------
def gpt_layer(p: Params, latent: torch.Tensor) -> torch.Tensor:
    """GPT latents (B, L, 1280) → (B, L, 1024), float32."""
    x = latent.float()
    for lin in p:
        x = nn.linear(lin, x)
    return x


def _mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _masked_group_norm(p: Params, x: torch.Tensor, keep: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(1, C) of each row over its own frames: x (B, T, C)
    float32, keep (B, T, 1)."""
    n = keep.sum(dim=(1, 2), keepdim=True) * x.shape[-1]
    mu = (x * keep).sum(dim=(1, 2), keepdim=True) / n
    var = ((x - mu).square() * keep).sum(dim=(1, 2), keepdim=True) / n
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def regulate(p: Params, feats: Sequence[torch.Tensor],
             frames: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The length regulator over rows of code features (each (L_b, 1024))
    to ``frames[b]`` mel frames each: (out (B, max frames, 512) float32,
    zero past each row; keep (B, max frames) bool)."""
    dev = feats[0].device
    n = max(frames)
    rows = []
    for f, y in zip(feats, frames):
        h = nn.linear(p["in_proj"], f.float())[None].transpose(1, 2)
        h = F.interpolate(h, size=int(y), mode="nearest")[0].transpose(0, 1)
        rows.append(F.pad(h, (0, 0, 0, n - int(y))))
    x = torch.stack(rows)
    keep = (torch.arange(n, device=dev)[None, :]
            < torch.as_tensor(list(frames), device=dev)[:, None])
    k3 = keep[..., None].float()
    for blk in p["blocks"]:
        x = nn.conv1d(blk["conv"], x * k3, padding=1)
        x = _mish(_masked_group_norm(blk["norm"], x, k3))
    return nn.conv1d(p["out"], x * k3) * k3, keep


# -- time ------------------------------------------------------------------
def timestep_embedding(t: torch.Tensor, dim: int = 256,
                       scale: float = 1000.0) -> torch.Tensor:
    """(S,) → (S, dim) float32, cos | sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = scale * t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _t_embed(p: Params, t: torch.Tensor, dim: int) -> torch.Tensor:
    h = nn.linear(p["l1"], timestep_embedding(t, dim))
    return nn.linear(p["l2"], nn.silu(h))


def modulations(p: Params, cfg: S2MConfig, t: torch.Tensor) -> Dict[str, Any]:
    """Everything of a forward that depends on the time alone, for the
    steps' times ``t`` (S,), float32: each block's two AdaRMS (w, b), the
    final AdaRMS, the final layer's (shift, scale) and the WaveNet's
    conditioning (S, 2·H·layers)."""
    d = p["dit"]
    t1 = _t_embed(d["t_embed"], t, cfg.time_freq_dim)
    t2 = _t_embed(d["t_embed2"], t, cfg.time_freq_dim)
    ada = lambda q: nn.linear(q["proj"], t1).chunk(2, dim=-1)
    shift, scale = nn.linear(d["final"]["mod"], nn.silu(t1)).chunk(2, dim=-1)
    return {"blocks": [(ada(b["attn_norm"]), ada(b["ffn_norm"]))
                       for b in d["blocks"]],
            "norm": ada(d["norm"]), "final": (shift, scale),
            "wn": nn.linear({"w": d["wn"]["cond"]["w"][0],
                             "b": d["wn"]["cond"]["b"]}, t2)}


def step_mods(mods: Dict[str, Any], s: int) -> Dict[str, Any]:
    """Step ``s``'s rows (each (1, ·)) of ``modulations``."""
    pick = lambda x: x[s: s + 1]
    return {"blocks": [tuple(tuple(pick(v) for v in n) for n in b)
                       for b in mods["blocks"]],
            "norm": tuple(pick(v) for v in mods["norm"]),
            "final": tuple(pick(v) for v in mods["final"]),
            "wn": pick(mods["wn"])}


# -- the DiT ---------------------------------------------------------------
def rotary(n: int, dim: int, device, base: float = 10000.0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gpt-fast's ``precompute_freqs_cis`` at positions 0..n-1: cos and sin
    (n, dim/2)."""
    freqs = 1.0 / (base ** (torch.arange(0, dim, 2, device=device)
                            [: dim // 2].float() / dim))
    ang = torch.outer(torch.arange(n, device=device).float(), freqs)
    return ang.cos(), ang.sin()


def apply_rotary(x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]
                 ) -> torch.Tensor:
    """x (B, n, H, d) → rotated pairs (2i, 2i+1), in x's dtype."""
    cos, sin = (r[None, :, None, :] for r in rope)
    xs = x.float().reshape(*x.shape[:-1], -1, 2)
    a, b = xs[..., 0], xs[..., 1]
    out = torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1)
    return out.flatten(3).to(x.dtype)


def _ada_rms(g: torch.Tensor, x: torch.Tensor, wb, eps: float
             ) -> torch.Tensor:
    w, b = wb
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g.float()
    return w[:, None] * y + b[:, None]


def attention(p: Params, cfg: S2MConfig, u: torch.Tensor,
              valid: Optional[torch.Tensor],
              rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    b, n, d = u.shape
    h = cfg.num_heads
    q, k, v = nn.linear(p["wqkv"], u).view(b, n, 3, h, d // h).unbind(2)
    q, k = apply_rotary(q, rope), apply_rotary(k, rope)
    mask = None if valid is None else valid[:, None, None, :]
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), attn_mask=mask)
    return nn.linear(p["wo"], o.transpose(1, 2).reshape(b, n, d))


def block(p: Params, cfg: S2MConfig, h: torch.Tensor, mod,
          valid: Optional[torch.Tensor], rope, dtype) -> torch.Tensor:
    """One gpt-fast block over the float32 residual h (B, N, D)."""
    attn_mod, ffn_mod = mod
    eps = cfg.norm_eps
    u = _ada_rms(p["attn_norm"]["g"], h, attn_mod, eps).to(dtype)
    h = h + attention(p, cfg, u, valid, rope).float()
    u = _ada_rms(p["ffn_norm"]["g"], h, ffn_mod, eps).to(dtype)
    f = nn.linear(p["w2"], nn.silu(nn.linear(p["w1"], u))
                  * nn.linear(p["w3"], u))
    return h + f.float()


def reflect_index(lens: Sequence[int], n: int, pad: int, device
                  ) -> torch.Tensor:
    """(B, n + 2·pad) gather indices that reflect-pad each row at its own
    two ends (``F.pad(..., mode="reflect")`` of the row alone)."""
    i = torch.arange(-pad, n + pad, device=device)[None, :]
    last = torch.as_tensor(list(lens), device=device)[:, None] - 1
    i = torch.where(i < 0, -i, torch.where(i > last, 2 * last - i, i))
    return i.clamp(0, n - 1)


def wavenet_pad(cfg: S2MConfig) -> int:
    """Every WaveNet layer's reflect padding on either side (dilation 1 in
    each, as published)."""
    return (cfg.wavenet_kernel - 1) // 2


def wavenet(p: Params, cfg: S2MConfig, x: torch.Tensor,
            keep: Optional[torch.Tensor], g: torch.Tensor,
            pad_idx: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """WN over x (B, N, H) float32 with conditioning g (1, 2·H·layers):
    (B, N, H) float32. ``pad_idx``: for a padded batch, the
    ``reflect_index`` of the padding; None reflects at the tensor's
    ends."""
    hc = cfg.wavenet_hidden
    pad = wavenet_pad(cfg)
    out = torch.zeros_like(x)
    n_layers = len(p["in"])
    for i, (conv, rs) in enumerate(zip(p["in"], p["res_skip"])):
        xd = x.to(dtype)
        if pad_idx is None:
            xp = F.pad(xd.transpose(1, 2), (pad, pad),
                       mode="reflect").transpose(1, 2)
        else:
            xp = torch.gather(xd, 1, pad_idx[..., None].expand(-1, -1, hc))
        a = nn.conv1d(conv, xp).float() \
            + g[:, None, 2 * hc * i: 2 * hc * (i + 1)]
        acts = torch.tanh(a[..., :hc]) * torch.sigmoid(a[..., hc:])
        r = nn.linear({"w": rs["w"][0], "b": rs["b"]}, acts.to(dtype)).float()
        if i < n_layers - 1:
            x = x + r[..., :hc]
            x = x if keep is None else x * keep
            out = out + r[..., hc:]
        else:
            out = out + r
    return out if keep is None else out * keep


def merge_const(p: Params, cfg: S2MConfig, prompt_x: torch.Tensor,
                mu: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """The part of the DiT's input projection that no step changes:
    ``W·[prompt_x, cond_projection(mu), style] + b`` (B, N, D), float32
    (the projection is linear, so a step adds the x part alone)."""
    m, c = cfg.in_channels, cfg.content_dim
    w = p["merge"]["w"].float()
    cond = nn.linear(p["cond_proj"], mu.float())
    out = prompt_x.float() @ w[m: 2 * m] + cond @ w[2 * m: 2 * m + c]
    return out + (style.float() @ w[2 * m + c:])[:, None] \
        + p["merge"]["b"].float()


def forward(params: Params, cfg: S2MConfig, x: torch.Tensor,
            const: torch.Tensor, mods: Dict[str, Any],
            valid: Optional[torch.Tensor], rope, pad_idx=None
            ) -> torch.Tensor:
    """One DiT forward: x (B, N, 80) float32, ``const`` from
    ``merge_const``, ``mods`` this step's (``step_mods``), ``valid``
    (B, N) or None → the velocity (B, N, 80) float32. The compute dtype is
    the parameters'."""
    p = params["dit"]
    dtype = p["merge"]["w"].dtype
    m = cfg.in_channels
    h = _lin({"w": p["merge"]["w"][:m]}, x, dtype) + const
    keep = None if valid is None else valid[..., None].float()
    skips: List[torch.Tensor] = []
    half = cfg.depth // 2
    for i, (blk, mod) in enumerate(zip(p["blocks"], mods["blocks"])):
        if i > half:
            h = _lin(blk["skip_in"], torch.cat([h, skips.pop()], dim=-1),
                     dtype)
        h = block(blk, cfg, h, mod, valid, rope, dtype)
        if i < half:
            skips.append(h)
    h = _ada_rms(p["norm"]["g"], h, mods["norm"], cfg.norm_eps)
    h = _lin(p["skip"], torch.cat([h, x], dim=-1), dtype)
    w = _lin(p["conv1"], h, dtype)
    y = wavenet(p["wn"], cfg, w, keep, mods["wn"], pad_idx, dtype) \
        + _lin(p["res_proj"], h, dtype)
    shift, scale = mods["final"]
    y = F.layer_norm(y, y.shape[-1:], eps=1e-6) * (1 + scale[:, None]) \
        + shift[:, None]
    y = nn.linear(p["final"]["linear"], y.to(dtype))
    return nn.linear({"w": p["conv2"]["w"][0], "b": p["conv2"]["b"]},
                     y).float()
