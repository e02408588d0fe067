"""BigVGAN generator, reference-structured and channels-last ``(B, T, C)``,
in plain PyTorch: gpt latent (B, T, gpt_dim) → conv_pre(k7) → + speaker
conditioning → 6 transposed-conv upsample stages (×1024 in all), each with
its speaker-conditioning add and 3 anti-aliased-snake AMP resblocks →
snakebeta → conv_post(k7) → tanh → (B, T·1024) waveform.

A frozen copy of the port's ``models/bigvgan.py`` with every activation on
the exact route (no kernel), run over a whole stream at once: no windows,
no halos, no edge patches.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from perfbench.reference import nn
from perfbench.reference.alias_free import anti_aliased_activation

Params = Dict[str, Any]


def _act(cfg: Any, p: Params, x: torch.Tensor) -> torch.Tensor:
    beta = p.get("beta") if cfg.activation == "snakebeta" else None
    return anti_aliased_activation(x, p["alpha"], beta, cfg.snake_logscale)


def _amp_block(cfg: Any, p: Params, x: torch.Tensor, k: int,
               dilations: Sequence[int]) -> torch.Tensor:
    """AMPBlock1: 3× [act → dilated conv → act → conv] with residual adds."""
    for c1, c2, a1, a2, d in zip(p["convs1"], p["convs2"], p["acts"][::2],
                                 p["acts"][1::2], dilations):
        xt = _act(cfg, a1, x)
        xt = nn.conv1d(c1, xt, dilation=d, padding=(k * d - d) // 2)
        xt = _act(cfg, a2, xt)
        xt = nn.conv1d(c2, xt, padding=(k - 1) // 2)
        x = xt + x
    return x


def generate(params: Params, cfg: Any, latent: torch.Tensor,
             spk: torch.Tensor) -> torch.Tensor:
    """latent (B, T, gpt_dim) + speaker embedding (B, 1, spk_dim) → wav
    (B, T·1024): the generator after the speaker encoder."""
    x = nn.conv1d(params["conv_pre"], latent, padding=3)
    x = x + nn.conv1d(params["cond_layer"], spk)
    for i in range(cfg.num_upsamples):
        u = cfg.upsample_rates[i]
        k = cfg.upsample_kernel_sizes[i]
        x = nn.conv_transpose1d(params["ups"][i], x, stride=u,
                                padding=(k - u) // 2)
        if cfg.cond_in_each_up_layer:
            x = x + nn.conv1d(params["conds"][i], spk)
        xs = None
        for j in range(cfg.num_kernels):
            rb = params["resblocks"][i * cfg.num_kernels + j]
            y = _amp_block(cfg, rb, x, cfg.resblock_kernel_sizes[j],
                           cfg.resblock_dilation_sizes[j])
            xs = y if xs is None else xs + y
        x = xs / cfg.num_kernels
    x = _act(cfg, params["act_post"], x)
    x = nn.conv1d(params["conv_post"], x, padding=3)
    return torch.tanh(x)[..., 0]
