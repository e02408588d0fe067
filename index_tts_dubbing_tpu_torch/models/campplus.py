"""CAM++ (3D-Speaker), the speaker model whose 192-d embedding is the
S2M DiT's style, channels-last.

Published description: 3D-Speaker's ``speakerlab/models/campplus/
DTDNN.py`` (``CAMPPlus``) and ``layers.py``, as IndexTTS-2 builds it,
``CAMPPlus(feat_dim=80, embedding_size=192)``, in inference:

- ``FCM`` over the fbank as a one-channel image (frequency × time):
  Conv2d(1, 32, 3, pad 1) → BN → ReLU, two stages of two
  ``BasicResBlock``s (the first of each strided 2 along frequency, with a
  1 × 1 strided shortcut), Conv2d(32, 32, 3, stride (2, 1), pad 1) → BN →
  ReLU, flattened channel-major to 32 · 10 = 320 channels over time;
- a TDNN layer: Conv1d(320, 128, 5, stride 2, pad 2, no bias) → BN → ReLU;
- three CAM dense blocks of 12, 24 and 16 layers (growth 32, bottleneck
  128, kernel 3, dilation 1, 2, 2), each followed by a transit layer (BN →
  ReLU → 1 × 1 conv halving the channels, no bias). A dense layer: BN →
  ReLU → 1 × 1 conv to 128 (no bias) → BN → ReLU → CAM: a local conv
  (kernel 3, no bias) times the sigmoid of a context gate, the gate a
  1 × 1 conv (128 → 64, bias) → ReLU → 1 × 1 conv (64 → 32, bias) over
  the time mean plus the mean of each 100-frame segment (average pooling
  with the last segment partial, repeated over its frames); its output is
  concatenated to its input;
- BN → ReLU, statistics pooling (mean and unbiased std over time), a
  1 × 1 conv (1024 → 192, no bias) and a BN without affine.

Every BN is the inference form (running statistics, eps 1e-5).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.config import CAMPPlusConfig

Params = Dict[str, Any]
_PAD = ((1, 1), (1, 1))
SEG = 100


def _bn_relu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.relu(nn.batch_norm(p, x))


def _res_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """x (B, F, T, C)."""
    out = _bn_relu(p["bn1"], nn.conv2d(p["conv1"], x, stride=(stride, 1),
                                       padding=_PAD))
    out = nn.batch_norm(p["bn2"], nn.conv2d(p["conv2"], out, padding=_PAD))
    if "shortcut" in p:
        x = nn.batch_norm(p["shortcut_bn"],
                          nn.conv2d(p["shortcut"], x, stride=(stride, 1)))
    return torch.relu(out + x)


def fcm(p: Params, x: torch.Tensor) -> torch.Tensor:
    """fbank (B, T, F) → (B, T, m_channels · F/8), channel-major."""
    h = _bn_relu(p["bn1"], nn.conv2d(p["conv1"], x.transpose(1, 2)[..., None],
                                     padding=_PAD))
    for stage in p["layers"]:
        for i, blk in enumerate(stage):
            h = _res_block(blk, h, 2 if i == 0 else 1)
    h = _bn_relu(p["bn2"], nn.conv2d(p["conv2"], h, stride=(2, 1),
                                     padding=_PAD))
    b, f, t, c = h.shape
    return h.permute(0, 2, 3, 1).reshape(b, t, c * f)


def seg_pooling(x: torch.Tensor) -> torch.Tensor:
    """The mean of each ``SEG``-frame segment of x (B, T, C), repeated over
    its frames."""
    t = x.shape[1]
    seg = F.avg_pool1d(x.transpose(1, 2), SEG, SEG, ceil_mode=True)
    return seg.repeat_interleave(SEG, dim=-1)[..., :t].transpose(1, 2)


def cam_layer(p: Params, x: torch.Tensor, dilation: int) -> torch.Tensor:
    k = p["local"]["w"].shape[0]
    y = nn.conv1d(p["local"], x, dilation=dilation,
                  padding=(k - 1) // 2 * dilation)
    ctx = x.mean(dim=1, keepdim=True) + seg_pooling(x)
    m = torch.sigmoid(nn.conv1d(p["linear2"],
                                torch.relu(nn.conv1d(p["linear1"], ctx))))
    return y * m


def dense_layer(p: Params, x: torch.Tensor, dilation: int) -> torch.Tensor:
    h = nn.conv1d(p["linear1"], _bn_relu(p["bn1"], x))
    return cam_layer(p["cam"], _bn_relu(p["bn2"], h), dilation)


def forward(p: Params, cfg: CAMPPlusConfig, feats: torch.Tensor
            ) -> torch.Tensor:
    """CAM++'s fbank features (B, T, 80) → the embedding (B, 192)."""
    x = fcm(p["head"], feats)
    x = _bn_relu(p["tdnn"]["bn"], nn.conv1d(p["tdnn"]["conv"], x, stride=2,
                                            padding=2))
    for block, transit, dil in zip(p["blocks"], p["transits"],
                                   cfg.block_dilations):
        for lyr in block:
            x = torch.cat([x, dense_layer(lyr, x, dil)], dim=-1)
        x = nn.conv1d(transit["conv"], _bn_relu(transit["bn"], x))
    x = _bn_relu(p["out_bn"], x)
    stats = torch.cat([x.mean(dim=1), x.std(dim=1, unbiased=True)], dim=-1)
    emb = nn.conv1d(p["dense"], stats[:, None])
    return nn.batch_norm(p["dense_bn"], emb)[:, 0]
