"""DiscreteVAE speech codec: defines the 8192-code mel-token space.

Counterpart of the JAX package's ``models/dvae.py``, after the reference's
vqvae/xtts_dvae.py (DiscreteVAE, Quantize) at the IndexTTS config: 100 mel
channels, 8192 tokens, 512-d codebook, 2 stride-2 conv layers (4 mel
frames per code), 3 resblocks, a nearest-upsample decoder, ReLU. Layout
channels-last (B, T, C), conv kernels (K, Cin, Cout), as in ``nn``.

The reference uses it offline (tokenising, debugging); here it also gives
the training pipeline its codes. The EMA codebook update is a pure
function on tensors (``ema_update``). Reference checkpoints load through
``utils/convert.py convert_dvae``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.weights import Init

Params = Dict[str, Any]


@dataclass(frozen=True)
class DVAEConfig:
    channels: int = 100
    num_tokens: int = 8192
    hidden_dim: int = 512
    num_resnet_blocks: int = 3
    codebook_dim: int = 512
    num_layers: int = 2
    kernel_size: int = 3
    stride: int = 2


def _res_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """conv3 → relu → conv3 → relu → conv1, plus the residual."""
    h = torch.relu(nn.conv1d(p["c1"], x, padding=1))
    h = torch.relu(nn.conv1d(p["c2"], h, padding=1))
    return nn.conv1d(p["c3"], h) + x


def encode(params: Params, cfg: DVAEConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, C_mel) → logits (B, T/4, codebook_dim)."""
    x = mel
    pad = (cfg.kernel_size - 1) // 2
    for layer in params["enc_convs"]:
        x = torch.relu(nn.conv1d(layer, x, stride=cfg.stride, padding=pad))
    for rb in params["enc_res"]:
        x = _res_block(rb, x)
    return nn.conv1d(params["enc_out"], x)


def decode_embeds(params: Params, cfg: DVAEConfig,
                  emb: torch.Tensor) -> torch.Tensor:
    """codebook embeds (B, N, D) → mel (B, N·4, C_mel)."""
    x = nn.conv1d(params["dec_in"], emb)
    for rb in params["dec_res"]:
        x = _res_block(rb, x)
    pad = (cfg.kernel_size - 1) // 2
    for layer in params["dec_convs"]:
        # nearest ×2 upsample, then a same-width conv
        x = x.repeat_interleave(cfg.stride, dim=1)
        x = torch.relu(nn.conv1d(layer, x, padding=pad))
    return nn.conv1d(params["dec_out"], x)


def embed_code(params: Params, codes: torch.Tensor) -> torch.Tensor:
    return params["codebook"]["embed"].T[codes]


def quantize(params: Params, logits: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest-codebook lookup: (quantized with the straight-through
    gradient, codes, commitment loss)."""
    embed = params["codebook"]["embed"]            # (D, n_embed)
    flat = logits.reshape(-1, logits.shape[-1])
    dist = (flat.square().sum(1, keepdim=True) - 2.0 * flat @ embed
            + embed.square().sum(0, keepdim=True))
    codes = torch.argmin(dist, dim=1).reshape(logits.shape[:-1])
    quant = embed_code(params, codes)
    diff = (quant.detach() - logits).square().mean()
    quant = logits + (quant - logits).detach()
    return quant, codes, diff


def get_codebook_indices(params: Params, cfg: DVAEConfig,
                         mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, C) → codes (B, T/4)."""
    return quantize(params, encode(params, cfg, mel))[1]


def decode(params: Params, cfg: DVAEConfig, codes: torch.Tensor
           ) -> torch.Tensor:
    """codes (B, N) → mel (B, N·4, C)."""
    return decode_embeds(params, cfg, embed_code(params, codes))


def forward_train(params: Params, cfg: DVAEConfig, mel: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(reconstruction loss [smooth L1], commitment loss, reconstruction),
    as DiscreteVAE.forward in training mode."""
    logits = encode(params, cfg, mel)
    quant, _, commitment = quantize(params, logits)
    recon = decode_embeds(params, cfg, quant)[:, : mel.shape[1]]
    d = recon - mel
    ad = d.abs()
    recon_loss = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).mean()
    return recon_loss, commitment, recon


def discretization_loss(soft_onehot: torch.Tensor, dim: int,
                        expected_variance: float) -> torch.Tensor:
    """Fit the mean code utilisation to a zero-mean normal PDF (the
    reference's DiscretizationLoss without its rolling accumulator)."""
    axes = tuple(i for i in range(soft_onehot.ndim) if i != dim)
    averaged = soft_onehot.sum(dim=axes) / soft_onehot.sum()
    averaged = averaged - averaged.mean()
    var = expected_variance
    log_prob = (-0.5 * (averaged / var).square()
                - math.log(var) - 0.5 * math.log(2 * math.pi))
    return (-log_prob).sum()


class EMAState(NamedTuple):
    cluster_size: torch.Tensor  # (n_embed,)
    embed_avg: torch.Tensor     # (D, n_embed)


def ema_update(params: Params, state: EMAState, logits: torch.Tensor,
               codes: torch.Tensor, decay: float = 0.99, eps: float = 1e-5,
               group=None) -> Tuple[Params, EMAState]:
    """EMA codebook update: new (params, state); the inputs are not
    changed. ``group``: a process group (a mesh's ``data`` group, the JAX
    ``axis_name``) over which the code counts and embedding sums are summed
    before the update, so each rank updates as one process would on the
    whole batch."""
    n_embed = state.cluster_size.shape[0]
    flat = logits.reshape(-1, logits.shape[-1])
    onehot = torch.nn.functional.one_hot(codes.reshape(-1), n_embed
                                         ).to(flat.dtype)
    onehot_sum, embed_sum = onehot.sum(0), flat.T @ onehot
    if group is not None:
        for t in (onehot_sum, embed_sum):
            dist.all_reduce(t, group=group)
    cluster = state.cluster_size * decay + onehot_sum * (1 - decay)
    embed_avg = state.embed_avg * decay + embed_sum * (1 - decay)
    n = cluster.sum()
    cs = (cluster + eps) / (n + n_embed * eps) * n
    new_params = dict(params)
    new_params["codebook"] = {"embed": embed_avg / cs[None, :]}
    return new_params, EMAState(cluster, embed_avg)


def init(cfg: DVAEConfig, generator: torch.Generator, device="cuda") -> Params:
    """Random parameters in the JAX init's shapes and distributions
    (torch-default conv bounds, a unit-normal codebook)."""
    r = Init(generator, device)
    k = cfg.kernel_size
    enc_chans = [cfg.hidden_dim * 2 ** i for i in range(cfg.num_layers)]
    dec_chans = list(reversed(enc_chans))
    inner = dec_chans[0]

    def res():
        return {"c1": r.conv1d(inner, inner, 3), "c2": r.conv1d(inner, inner, 3),
                "c3": r.conv1d(inner, inner, 1)}

    return {
        "enc_convs": [r.conv1d(i, o, k) for i, o in
                      zip([cfg.channels] + enc_chans, enc_chans)],
        "enc_res": [res() for _ in range(cfg.num_resnet_blocks)],
        "enc_out": r.conv1d(inner, cfg.codebook_dim, 1),
        "dec_in": r.conv1d(cfg.codebook_dim, inner, 1),
        "dec_res": [res() for _ in range(cfg.num_resnet_blocks)],
        "dec_convs": [r.conv1d(i, o, k) for i, o in
                      zip([dec_chans[0]] + dec_chans, dec_chans)],
        "dec_out": r.conv1d(dec_chans[-1], cfg.channels, 1),
        "codebook": {"embed": r.normal((cfg.codebook_dim, cfg.num_tokens),
                                       std=1.0)},
    }
