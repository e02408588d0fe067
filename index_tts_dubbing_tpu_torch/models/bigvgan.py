"""BigVGAN generator, reference-structured and channels-last ``(B, T, C)``.

Counterpart of the JAX package's ``models/bigvgan.py``: gpt latent
(B, T, gpt_dim) → conv_pre(k7) → + speaker conditioning → 6 transposed-conv
upsample stages (×1024 in all), each with its speaker-conditioning add and
3 anti-aliased-snake AMP resblocks → snakebeta → conv_post(k7) → tanh →
(B, T·1024) waveform. The mel-vocoder form (``MelVocoderConfig``: a
log-mel in, ×256, no speaker input, conv_post without a bias and a clamp to
[-1, 1] for tanh) takes ``spk`` None. Every anti-aliased activation reads
``cfg.use_pallas``: False is the exact route, True is kernel B3
(ops/snake_clast.py). The parameters come from ``weights.init_bigvgan`` or
``weights.from_jax_params``.

The engine's own vocoder is the C-major one (engine/vocoder.py); this
structure is the windowed vocoder's ``layout="ref"``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.config import BigVGANConfig
from index_tts_dubbing_tpu_torch.models import ecapa
from index_tts_dubbing_tpu_torch.ops.alias_free import anti_aliased_activation

Params = Dict[str, Any]


def _act(cfg: BigVGANConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    beta = p.get("beta") if cfg.activation == "snakebeta" else None
    if cfg.use_pallas:
        # the convs leave (B, T, C) views of C-major memory; B3 reads C
        # contiguous
        x = x.contiguous()
    return anti_aliased_activation(x, p["alpha"], beta, cfg.snake_logscale,
                                   use_pallas=cfg.use_pallas)


def _amp_block(cfg: BigVGANConfig, p: Params, x: torch.Tensor, k: int,
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


def final(cfg: BigVGANConfig, x: torch.Tensor) -> torch.Tensor:
    """The generator's last op: tanh, or a clamp to [-1, 1]."""
    return torch.tanh(x) if cfg.use_tanh_at_final else x.clamp(-1.0, 1.0)


def generate(params: Params, cfg: BigVGANConfig, latent: torch.Tensor,
             spk: Optional[torch.Tensor]) -> torch.Tensor:
    """latent (B, T, gpt_dim) + speaker embedding (B, 1, spk_dim), or None
    for the mel vocoder → wav (B, T·upsample): the generator after the
    speaker encoder."""
    x = nn.conv1d(params["conv_pre"], latent, padding=3)
    if spk is not None:
        x = x + nn.conv1d(params["cond_layer"], spk)
    for i in range(cfg.num_upsamples):
        u = cfg.upsample_rates[i]
        k = cfg.upsample_kernel_sizes[i]
        x = nn.conv_transpose1d(params["ups"][i], x, stride=u,
                                padding=(k - u) // 2)
        if cfg.cond_in_each_up_layer and spk is not None:
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
    return final(cfg, x)[..., 0]


def forward(params: Params, cfg: BigVGANConfig, latent: torch.Tensor,
            mel_ref: torch.Tensor) -> torch.Tensor:
    """latent (B, T, gpt_dim), mel_ref (B, T_ref, num_mels) → wav (B, T·1024)."""
    spk = ecapa.forward(params["speaker_encoder"], mel_ref)    # (B, 1, spk_dim)
    return generate(params, cfg, latent, spk)
