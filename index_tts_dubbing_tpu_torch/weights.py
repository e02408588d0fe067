"""Parameters: the bridge from the JAX package's parameter trees, and the
port's own random initialisation.

``from_jax_params`` carries a JAX parameter tree (nested dicts and lists of
numpy, ``ml_dtypes`` or JAX arrays) across as the same tree of tensors. The
GPT trunk's stacked ``blocks`` (one dict whose leaves lead with a layers
axis) become a list of per-layer dicts, which is the port's layout. Tensor
leaves pass through, moved and cast, so the port's own tree takes the same
call.

``init`` builds full-width random weights without JAX, with the JAX
package's tree, shapes and distributions (torch's default inits: uniform
fan-in bounds for linear and conv, N(0, 0.02) for embeddings and the GPT
trunk), drawn from a ``torch.Generator`` directly on ``device``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from index_tts_dubbing_tpu_torch.config import (BigVGANConfig, EngineConfig,
                                                GPTConfig)
from index_tts_dubbing_tpu_torch.models import conformer, ecapa

Params = Dict[str, Any]


def _to_tensor(x, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x
    else:
        arr = np.array(x)      # a writable copy: JAX arrays view read-only
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax_params(tree, device, dtype: Optional[torch.dtype] = None):
    """JAX parameter tree (or the port's own) → the port's tree of tensors
    on ``device`` (floating leaves cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            if key == "blocks" and isinstance(val, dict):   # stacked GPT trunk
                n = len(np.asarray(_first_leaf(val)))
                val = [_index_tree(val, i) for i in range(n)]
            out[key] = from_jax_params(val, device, dtype)
        return out
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device, dtype) for v in tree]
    return _to_tensor(tree, device, dtype)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index_tree(v, i) for v in tree]
    return np.asarray(tree)[i]


def cast_floating(tree, dtype: torch.dtype):
    """Cast every floating tensor of a tree to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_floating(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


class Init:
    """Random draws on one device from one generator."""

    def __init__(self, generator: torch.Generator, device):
        self.g = generator
        self.device = device

    def uniform(self, shape, bound: float) -> torch.Tensor:
        u = torch.rand(shape, generator=self.g, device=self.device)
        return (u * 2.0 - 1.0) * bound

    def normal(self, shape, std: float = 0.02) -> torch.Tensor:
        return torch.randn(shape, generator=self.g, device=self.device) * std

    def ones(self, n):
        return torch.ones(n, device=self.device)

    def zeros(self, n):
        return torch.zeros(n, device=self.device)

    # layers, with the JAX package's shapes and torch-default bounds
    def linear(self, din: int, dout: int, bias: bool = True) -> Params:
        bound = 1.0 / math.sqrt(din)
        p = {"w": self.uniform((din, dout), bound)}
        if bias:
            p["b"] = self.uniform((dout,), bound)
        return p

    def conv1d(self, cin: int, cout: int, k: int, groups: int = 1) -> Params:
        bound = 1.0 / math.sqrt((cin // groups) * k)
        return {"w": self.uniform((k, cin // groups, cout), bound),
                "b": self.uniform((cout,), bound)}

    def conv_transpose1d(self, cin: int, cout: int, k: int) -> Params:
        bound = 1.0 / math.sqrt(cout * k)
        return {"w": self.uniform((k, cout, cin), bound),
                "b": self.uniform((cout,), bound)}

    def conv2d(self, cin: int, cout: int, kh: int, kw: int) -> Params:
        bound = 1.0 / math.sqrt(cin * kh * kw)
        return {"w": self.uniform((kh, kw, cin, cout), bound),
                "b": self.uniform((cout,), bound)}

    def layer_norm(self, d: int) -> Params:
        return {"g": self.ones(d), "b": self.zeros(d)}

    def batch_norm(self, c: int) -> Params:
        return {"g": self.ones(c), "b": self.zeros(c), "mean": self.zeros(c),
                "var": self.ones(c)}


def _conformer(r: Init, input_size: int, d: int, heads: int, units: int,
               num_blocks: int, cnn_kernel: int = 15, max_len: int = 5000) -> Params:
    dk = d // heads
    xavier = math.sqrt(6.0 / (heads * dk + dk))
    p: Params = {
        "embed": {"conv": r.conv2d(1, d, 3, 3),
                  "out": r.linear(d * ((input_size - 1) // 2), d)},
        "pe": torch.as_tensor(conformer.sinusoidal_pos(max_len, d),
                              device=r.device),
        "blocks": [],
        "after_norm": r.layer_norm(d),
    }
    for _ in range(num_blocks):
        p["blocks"].append({
            "norm_mha": r.layer_norm(d),
            "attn": {
                "q": r.linear(d, d), "k": r.linear(d, d), "v": r.linear(d, d),
                "pos": {"w": r.uniform((d, d), math.sqrt(6.0 / (2 * d)))},
                "out": r.linear(d, d),
                "pos_bias_u": r.uniform((heads, dk), xavier),
                "pos_bias_v": r.uniform((heads, dk), xavier),
            },
            "norm_conv": r.layer_norm(d),
            "conv": {"pw1": r.conv1d(d, 2 * d, 1),
                     "dw": r.conv1d(d, d, cnn_kernel, groups=d),
                     "ln": r.layer_norm(d),
                     "pw2": r.conv1d(d, d, 1)},
            "norm_ff": r.layer_norm(d),
            "ff": {"w1": r.linear(d, units), "w2": r.linear(units, d)},
            "norm_final": r.layer_norm(d),
        })
    return p


def init_perceiver(r: Init, dim: int, dim_context: int, num_latents: int,
                   dim_head: int, heads: int, ff_mult: int,
                   depth: int = 2) -> Params:
    inner = dim_head * heads
    ff_inner = int(dim * ff_mult * 2 / 3)
    return {
        "proj_context": r.linear(dim_context, dim),
        "latents": r.normal((num_latents, dim)),
        "layers": [{
            "attn": {"to_q": r.linear(dim, inner, bias=False),
                     "to_kv": r.linear(dim, inner * 2, bias=False),
                     "to_out": r.linear(inner, dim, bias=False)},
            "ff": {"w1": r.linear(dim, ff_inner * 2),
                   "w2": r.linear(ff_inner, dim)},
        } for _ in range(depth)],
        "norm": {"g": r.ones(dim)},
    }


def init_gpt(r: Init, cfg: GPTConfig) -> Params:
    d = cfg.model_dim
    return {
        "cond_encoder": _conformer(r, 100, cfg.cond_output_size,
                                   cfg.cond_attention_heads,
                                   cfg.cond_linear_units, cfg.cond_num_blocks),
        "perceiver": init_perceiver(r, d, cfg.cond_output_size,
                                    cfg.condition_num_latent, 64,
                                    cfg.cond_attention_heads,
                                    cfg.perceiver_mult),
        "text_emb": {"w": r.normal((cfg.number_text_tokens + 1, d))},
        "mel_emb": {"w": r.normal((cfg.number_mel_codes, d))},
        "text_pos": {"w": r.normal((cfg.max_text_seq, d))},
        "mel_pos": {"w": r.normal((cfg.max_mel_seq, d))},
        "blocks": [{
            "ln1": r.layer_norm(d),
            "attn": {"qkv": {"w": r.normal((d, 3 * d)), "b": r.zeros(3 * d)},
                     "proj": {"w": r.normal((d, d)), "b": r.zeros(d)}},
            "ln2": r.layer_norm(d),
            "mlp": {"fc": {"w": r.normal((d, 4 * d)), "b": r.zeros(4 * d)},
                    "proj": {"w": r.normal((4 * d, d)), "b": r.zeros(d)}},
        } for _ in range(cfg.layers)],
        "ln_f": r.layer_norm(d),
        "final_norm": r.layer_norm(d),
        "text_head": r.linear(d, cfg.number_text_tokens + 1),
        "mel_head": r.linear(d, cfg.number_mel_codes),
    }


def _tdnn(r: Init, cin: int, cout: int, k: int) -> Params:
    return {"conv": r.conv1d(cin, cout, k), "bn": r.batch_norm(cout)}


def init_ecapa(r: Init, input_size: int, lin_neurons: int) -> Params:
    ch, ks, scale = ecapa.CHANNELS, ecapa.KERNELS, ecapa.RES2NET_SCALE
    blocks: list = [_tdnn(r, input_size, ch[0], ks[0])]
    for i in range(1, len(ch) - 1):
        inner = ch[i] // scale
        blocks.append({
            "tdnn1": _tdnn(r, ch[i - 1], ch[i], 1),
            "res2net": {"blocks": [_tdnn(r, inner, inner, ks[i])
                                   for _ in range(scale - 1)]},
            "tdnn2": _tdnn(r, ch[i], ch[i], 1),
            "se": {"conv1": r.conv1d(ch[i], ecapa.SE_CHANNELS, 1),
                   "conv2": r.conv1d(ecapa.SE_CHANNELS, ch[i], 1)},
        })
    return {
        "blocks": blocks,
        "mfa": _tdnn(r, ch[-2] * 3, ch[-1], ks[-1]),
        "asp": {"tdnn": _tdnn(r, ch[-1] * 3, ecapa.ATTENTION_CHANNELS, 1),
                "conv": r.conv1d(ecapa.ATTENTION_CHANNELS, ch[-1], 1)},
        "asp_bn": r.batch_norm(ch[-1] * 2),
        "fc": r.conv1d(ch[-1] * 2, lin_neurons, 1),
    }


def _snake(r: Init, ch: int, cfg: BigVGANConfig) -> Params:
    a = r.zeros(ch) if cfg.snake_logscale else r.ones(ch)
    p = {"alpha": a}
    if cfg.activation == "snakebeta":
        p["beta"] = a.clone()
    return p


def init_bigvgan(r: Init, cfg: BigVGANConfig) -> Params:
    p: Params = {"conv_pre": r.conv1d(cfg.gpt_dim, cfg.upsample_initial_channel, 7),
                 "ups": [], "resblocks": [], "conds": []}
    ch_in = cfg.upsample_initial_channel
    for i in range(cfg.num_upsamples):
        ch = cfg.stage_channels(i)
        p["ups"].append(r.conv_transpose1d(ch_in, ch, cfg.upsample_kernel_sizes[i]))
        for k in cfg.resblock_kernel_sizes:
            p["resblocks"].append({
                "convs1": [r.conv1d(ch, ch, k) for _ in range(3)],
                "convs2": [r.conv1d(ch, ch, k) for _ in range(3)],
                "acts": [_snake(r, ch, cfg) for _ in range(6)],
            })
        p["conds"].append(r.conv1d(cfg.speaker_embedding_dim, ch, 1))
        ch_in = ch
    p["act_post"] = _snake(r, ch_in, cfg)
    p["conv_post"] = r.conv1d(ch_in, 1, 7)
    p["cond_layer"] = r.conv1d(cfg.speaker_embedding_dim,
                               cfg.upsample_initial_channel, 1)
    p["speaker_encoder"] = init_ecapa(r, cfg.num_mels, cfg.speaker_embedding_dim)
    return p


def init(cfg: EngineConfig, generator: torch.Generator, device="cuda",
         dtype: torch.dtype = torch.float32) -> Params:
    """Random {"gpt", "bigvgan"} parameters for ``cfg`` on ``device``."""
    r = Init(generator, device)
    params = {"gpt": init_gpt(r, cfg.gpt), "bigvgan": init_bigvgan(r, cfg.bigvgan)}
    return cast_floating(params, dtype) if dtype != torch.float32 else params
