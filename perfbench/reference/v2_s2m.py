"""IndexTTS-2's semantic-to-mel stage in plain PyTorch, for the reference:
one row at a time, written from the public source as it is laid out
there.

- ``gpt_layer``: ``indextts/s2mel/modules/commons.py`` ``MyModel``
  (``use_gpt_latent``): Sequential of Linear(1280, 256), Linear(256, 128),
  Linear(128, 1024);
- ``regulate``: ``length_regulator.py`` ``InterpolateRegulator.forward``
  (continuous input): ``content_in_proj``, ``F.interpolate(...,
  mode='nearest')`` to the target length, the model Sequential of
  (Conv1d(k 3, pad 1), GroupNorm(1), Mish) × 4 and Conv1d(k 1), times the
  sequence mask;
- ``dit``: ``diffusion_transformer.py`` ``DiT.forward`` with
  ``gpt_fast/model.py``'s ``Transformer`` (``AdaptiveLayerNorm`` over
  ``RMSNorm``, ``Attention`` with ``apply_rotary_emb``, ``FeedForward``,
  the U-ViT skip lists), ``TimestepEmbedder``, ``FinalLayer`` and
  ``wavenet.py``'s ``WN`` (encodec's ``SConv1d``: reflect padding);
- ``cfm``: ``flow_matching.py`` ``BASECFM.inference`` / ``solve_euler``
  (the uniform grid, ``t`` advanced by ``dt``, the prompt frames of x set
  to 0 before and after each step, the conditioned and unconditioned
  inputs stacked, ``(1 + cfg)·v − cfg·v_u``).

Computes in the given dtype (float32 for the reference, bfloat16 for the
control), its norms and softmax in float32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference.v2_front import _conv, _lin

Params = Dict[str, Any]


def gpt_layer(p: List[Params], latent: torch.Tensor) -> torch.Tensor:
    for lin in p:
        latent = _lin(lin, latent)
    return latent


def regulate(p: Params, x: torch.Tensor, ylen: int) -> torch.Tensor:
    """Code features (1, L, 1024) → (1, ylen, 512)."""
    x = _lin(p["in_proj"], x)
    x = F.interpolate(x.transpose(1, 2).contiguous(), size=ylen,
                      mode="nearest")
    for blk in p["blocks"]:
        x = _conv(blk["conv"], x, padding=1)
        x = F.group_norm(x.float(), 1, blk["norm"]["g"].float(),
                         blk["norm"]["b"].float()).to(x.dtype)
        x = F.mish(x)
    return _conv(p["out"], x).transpose(1, 2).contiguous()


def _timestep(p: Params, t: torch.Tensor, dtype) -> torch.Tensor:
    half = 128
    freqs = torch.exp(-math.log(10000) * torch.arange(
        0, half, dtype=torch.float32, device=t.device) / half)
    args = 1000 * t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1).to(dtype)
    return _lin(p["l2"], F.silu(_lin(p["l1"], emb)))


def _rms(g: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    out = (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                            + eps)).type_as(x)
    return out * g.to(x.dtype)


def _ada(p: Params, x: torch.Tensor, c: torch.Tensor, eps: float
         ) -> torch.Tensor:
    weight, bias = torch.split(_lin(p["proj"], c), x.shape[-1], dim=-1)
    return weight * _rms(p["g"], x, eps) + bias


def _rotary(x: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
    xs = x.float().reshape(*x.shape[:-1], -1, 2)
    fc = freqs_cis.view(1, xs.size(1), 1, xs.size(3), 2)
    out = torch.stack([xs[..., 0] * fc[..., 0] - xs[..., 1] * fc[..., 1],
                       xs[..., 1] * fc[..., 0] + xs[..., 0] * fc[..., 1]], -1)
    return out.flatten(3).type_as(x)


def _freqs_cis(n: int, dim: int, base: float, device) -> torch.Tensor:
    freqs = 1.0 / (base ** (torch.arange(0, dim, 2, device=device)
                            [: dim // 2].float() / dim))
    f = torch.outer(torch.arange(n, device=device).float(), freqs)
    cis = torch.polar(torch.ones_like(f), f)
    return torch.stack([cis.real, cis.imag], dim=-1)


def _transformer(p: Params, c: Dict[str, Any], x: torch.Tensor,
                 t1: torch.Tensor) -> torch.Tensor:
    n_layer, dim, heads = c["depth"], c["hidden_dim"], c["num_heads"]
    eps = c["norm_eps"]
    hd = dim // heads
    bsz, seqlen, _ = x.shape
    freqs = _freqs_cis(seqlen, hd, c["rope_base"], x.device)
    emit = [i for i in range(n_layer) if i < n_layer // 2]
    receive = [i for i in range(n_layer) if i > n_layer // 2]
    cond = t1[:, None]
    skips = []
    for i, blk in enumerate(p["blocks"]):
        if i in receive:
            x = _lin(blk["skip_in"], torch.cat([x, skips.pop(-1)], dim=-1))
        h = _ada(blk["attn_norm"], x, cond, eps)
        q, k, v = _lin(blk["wqkv"], h).split([dim, dim, dim], dim=-1)
        q = _rotary(q.view(bsz, seqlen, heads, hd), freqs)
        k = _rotary(k.view(bsz, seqlen, heads, hd), freqs)
        v = v.view(bsz, seqlen, heads, hd)
        q, k, v = (z.transpose(1, 2) for z in (q, k, v))
        w = torch.softmax((q @ k.transpose(-1, -2)).float() / math.sqrt(hd),
                          dim=-1).to(v.dtype)
        y = (w @ v).transpose(1, 2).contiguous().view(bsz, seqlen, dim)
        h = x + _lin(blk["wo"], y)
        u = _ada(blk["ffn_norm"], h, cond, eps)
        x = h + _lin(blk["w2"], F.silu(_lin(blk["w1"], u)) * _lin(blk["w3"],
                                                                   u))
        if i in emit:
            skips.append(x)
    return _ada(p["norm"], x, cond, eps)


def _wn(p: Params, c: Dict[str, Any], x: torch.Tensor, g: torch.Tensor
        ) -> torch.Tensor:
    """WN over (B, H, T) with g (B, H, 1); no padding, so the mask is 1."""
    hc, k = c["wavenet_hidden"], c["wavenet_kernel"]
    output = torch.zeros_like(x)
    g = _conv(p["cond"], g)
    n = len(p["in"])
    for i in range(n):
        dil = c["wavenet_dilation_rate"] ** i
        total = (k - 1) * dil
        xp = F.pad(x, (total - total // 2, total // 2), mode="reflect")
        x_in = _conv(p["in"][i], xp, dilation=dil)
        in_act = x_in + g[:, i * 2 * hc: (i + 1) * 2 * hc, :]
        acts = torch.tanh(in_act[:, :hc]) * torch.sigmoid(in_act[:, hc:])
        rs = _conv(p["res_skip"][i], acts)
        if i < n - 1:
            x = x + rs[:, :hc]
            output = output + rs[:, hc:]
        else:
            output = output + rs
    return output


def dit(p: Params, c: Dict[str, Any], x: torch.Tensor, prompt_x: torch.Tensor,
        t: torch.Tensor, style: torch.Tensor, cond: torch.Tensor
        ) -> torch.Tensor:
    """DiT.forward: x, prompt_x (B, 80, T), t (B,), style (B, 192), cond
    (B, T, 512) → (B, 80, T)."""
    dtype = x.dtype
    T = x.shape[-1]
    t1 = _timestep(p["t_embed"], t, dtype)
    cond = _lin(p["cond_proj"], cond)
    xt, px = x.transpose(1, 2), prompt_x.transpose(1, 2)
    x_in = torch.cat([xt, px, cond, style[:, None, :].repeat(1, T, 1)],
                     dim=-1)
    x_in = _lin(p["merge"], x_in)
    x_res = _transformer(p, c, x_in, t1)
    x_res = _lin(p["skip"], torch.cat([x_res, xt], dim=-1))
    h = _lin(p["conv1"], x_res).transpose(1, 2)
    t2 = _timestep(p["t_embed2"], t, dtype)
    h = _wn(p["wn"], c, h, t2.unsqueeze(2)).transpose(1, 2) \
        + _lin(p["res_proj"], x_res)
    shift, scale = _lin(p["final"]["mod"], F.silu(t1)).chunk(2, dim=1)
    h = F.layer_norm(h.float(), h.shape[-1:], eps=1e-6).to(dtype)
    h = h * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)
    h = _lin(p["final"]["linear"], h).transpose(1, 2)
    return _conv(p["conv2"], h)


def cfm(p: Params, c: Dict[str, Any], mu: torch.Tensor, prompt: torch.Tensor,
        style: torch.Tensor, z: torch.Tensor, steps: int, cfg_rate: float
        ) -> torch.Tensor:
    """solve_euler from the noise z (1, 80, T): mu (1, T, 512), prompt
    (1, 80, Tp), style (1, 192) → (1, 80, T)."""
    t_span = torch.linspace(0, 1, steps + 1, device=mu.device)
    t = t_span[0]
    dt = t_span[1] - t_span[0]
    x = z.clone()
    prompt_len = prompt.size(-1)
    prompt_x = torch.zeros_like(x)
    prompt_x[..., :prompt_len] = prompt[..., :prompt_len]
    x[..., :prompt_len] = 0
    for step in range(1, len(t_span)):
        stacked = dit(p, c, torch.cat([x, x]),
                      torch.cat([prompt_x, torch.zeros_like(prompt_x)]),
                      torch.stack([t, t]).to(x.dtype),
                      torch.cat([style, torch.zeros_like(style)]),
                      torch.cat([mu, torch.zeros_like(mu)]))
        v, v_u = stacked.chunk(2, dim=0)
        v = (1.0 + cfg_rate) * v - cfg_rate * v_u
        x = x + dt * v
        t = t + dt
        if step < len(t_span) - 1:
            dt = t_span[step + 1] - t
        x[:, :, :prompt_len] = 0
    return x
