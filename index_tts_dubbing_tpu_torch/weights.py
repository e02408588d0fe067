"""Parameters: the bridge from the JAX package's parameter trees, and the
port's own random initialisation.

``from_jax_params`` carries a JAX parameter tree (nested dicts and lists of
numpy, ``ml_dtypes`` or JAX arrays) across as the same tree of tensors. The
GPT trunk's stacked ``blocks`` (one dict whose leaves lead with a layers
axis) become a list of per-layer dicts, which is the port's layout. Tensor
leaves pass through, moved and cast, so the port's own tree takes the same
call.

``to_jax_params`` is the way back (the trunk stacked again, numpy
leaves), and ``jax_leaves``/``from_jax_leaves`` order a tree's leaves as
``jax.tree.flatten`` does: with them the training state (parameters and
Adam moments) is written in, and read from, the JAX package's layout.

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

from index_tts_dubbing_tpu_torch.config import (BigVGANConfig, DiTConfig,
                                                EngineConfig, F5Config,
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


def to_jax_params(tree):
    """The port's tree → the JAX package's layout as numpy: the GPT trunk's
    list of blocks stacked into one dict whose leaves lead with the layers
    axis (the inverse of ``from_jax_params``; bfloat16 leaves become
    float32). A tree of Adam moments, which has the parameters' structure,
    goes across the same way."""
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            val = to_jax_params(val)
            if key == "blocks" and isinstance(val, list) and val and all(
                    "ln1" in blk for blk in val):           # the GPT trunk
                val = _stack_trees(val)
            out[key] = val
        return out
    if isinstance(tree, (list, tuple)):
        return [to_jax_params(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stack_trees(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return [_stack_trees([t[i] for t in trees])
                for i in range(len(trees[0]))]
    return np.stack(trees)


def jax_leaves(tree) -> list:
    """The leaves of a tree in ``jax.tree.flatten`` order: dict keys
    sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in jax_leaves(v)]
    return [tree]


def from_jax_leaves(leaves, like):
    """The inverse of ``jax_leaves``: ``leaves`` placed into the structure
    of ``like`` (in the same layout). Returns (tree, leaves left over)."""
    if isinstance(like, dict):
        out = {}
        for k in sorted(like):
            out[k], leaves = from_jax_leaves(leaves, like[k])
        return {k: out[k] for k in like}, leaves
    if isinstance(like, (list, tuple)):
        out = []
        for v in like:
            x, leaves = from_jax_leaves(leaves, v)
            out.append(x)
        return out, leaves
    return leaves[0], leaves[1:]


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

    def around_one(self, shape, spread: float) -> torch.Tensor:
        """1 + uniform(±spread): a positive scale."""
        return 1.0 + self.uniform(shape, spread)

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


def init_gpt(r: Init, cfg: GPTConfig, cond_input: int = 100) -> Params:
    d = cfg.model_dim
    return {
        "cond_encoder": _conformer(r, cond_input, cfg.cond_output_size,
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


def init_ecapa_classifier(r: Init, input_size: int, lin_blocks: int = 0,
                          lin_neurons: int = 192, out_neurons: int = 1211
                          ) -> Params:
    """``ecapa.classifier_forward``'s tree, with JAX ``classifier_init``'s
    keys, shapes and Glorot-uniform limits."""
    p: Params = {"blocks": []}
    d = input_size
    for _ in range(lin_blocks):
        p["blocks"].append({
            "bn": r.batch_norm(d),
            "lin": {"w": r.uniform((d, lin_neurons),
                                   math.sqrt(6.0 / (d + lin_neurons))),
                    "b": r.zeros(lin_neurons)}})
        d = lin_neurons
    p["weight"] = r.uniform((out_neurons, d),
                            math.sqrt(6.0 / (out_neurons + d)))
    return p


def _snake(r: Init, ch: int, cfg: BigVGANConfig) -> Params:
    a = r.zeros(ch) if cfg.snake_logscale else r.ones(ch)
    p = {"alpha": a}
    if cfg.activation == "snakebeta":
        p["beta"] = a.clone()
    return p


def init_bigvgan(r: Init, cfg: BigVGANConfig) -> Params:
    """The generator's tree; the mel-vocoder form (``MelVocoderConfig``)
    has no ``conds``, ``cond_layer`` or speaker encoder and may have no
    conv_post bias."""
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
        if cfg.speaker_conditioned:
            p["conds"].append(r.conv1d(cfg.speaker_embedding_dim, ch, 1))
        ch_in = ch
    p["act_post"] = _snake(r, ch_in, cfg)
    p["conv_post"] = r.conv1d(ch_in, 1, 7)
    if not cfg.use_bias_at_final:
        del p["conv_post"]["b"]
    if not cfg.speaker_conditioned:
        del p["conds"]
        return p
    p["cond_layer"] = r.conv1d(cfg.speaker_embedding_dim,
                               cfg.upsample_initial_channel, 1)
    p["speaker_encoder"] = init_ecapa(r, cfg.num_mels, cfg.speaker_embedding_dim)
    return p


def init_dit(r: Init, cfg: DiTConfig) -> Params:
    """F5-TTS's DiT (models/dit.py) with torch's default draws (uniform
    fan-in bounds, N(0, 1) for the text embedding), LayerNorm at one and
    zero, and GRN's gamma and beta drawn in ±0.5 (zero in the published
    initialisation, which a trained model leaves)."""
    d, t, m = cfg.dim, cfg.text_dim, cfg.mel_dim
    inner = cfg.heads * cfg.dim_head
    k, g = cfg.conv_pos_kernel, cfg.conv_pos_groups
    return {
        "text": {
            "emb": {"w": r.normal((cfg.text_num_embeds + 1, t), 1.0)},
            "blocks": [{
                "dw": r.conv1d(t, t, 7, groups=t),
                "norm": r.layer_norm(t),
                "pw1": r.linear(t, 2 * t),
                "grn": {"gamma": r.uniform((2 * t,), 0.5),
                        "beta": r.uniform((2 * t,), 0.5)},
                "pw2": r.linear(2 * t, t),
            } for _ in range(cfg.conv_layers)],
        },
        "time": {"l1": r.linear(cfg.time_freq_dim, d), "l2": r.linear(d, d)},
        "input": {"proj": r.linear(2 * m + t, d),
                  "conv1": r.conv1d(d, d, k, groups=g),
                  "conv2": r.conv1d(d, d, k, groups=g)},
        "blocks": [{
            "mod": r.linear(d, 6 * d),
            "q": r.linear(d, inner), "k": r.linear(d, inner),
            "v": r.linear(d, inner), "o": r.linear(inner, d),
            "ff1": r.linear(d, cfg.ff_mult * d),
            "ff2": r.linear(cfg.ff_mult * d, d),
        } for _ in range(cfg.depth)],
        "final": {"mod": r.linear(d, 2 * d), "proj": r.linear(d, m)},
    }


def init_f5(cfg: F5Config, generator: torch.Generator, device="cuda",
            dtype: torch.dtype = torch.float32) -> Params:
    """Random {"dit", "vocoder"} parameters for ``cfg`` on ``device``: the
    DiT in ``dtype``, the vocoder in float32."""
    r = Init(generator, device)
    dit = init_dit(r, cfg.dit)
    return {"dit": cast_floating(dit, dtype) if dtype != torch.float32
            else dit, "vocoder": init_bigvgan(r, cfg.vocoder)}


def init(cfg: EngineConfig, generator: torch.Generator, device="cuda",
         dtype: torch.dtype = torch.float32) -> Params:
    """Random {"gpt", "bigvgan"} parameters for ``cfg`` on ``device``."""
    r = Init(generator, device)
    params = {"gpt": init_gpt(r, cfg.gpt), "bigvgan": init_bigvgan(r, cfg.bigvgan)}
    return cast_floating(params, dtype) if dtype != torch.float32 else params


# -- IndexTTS-2 ---------------------------------------------------------------
def _w2vbert(r, c) -> Params:
    d, dh = c.hidden, c.hidden // c.heads
    ln = r.layer_norm
    return {
        "proj_ln": ln(c.feature_dim), "proj": r.linear(c.feature_dim, d),
        "layers": [{
            "ffn1_ln": ln(d), "ffn1": {"inter": r.linear(d, c.intermediate),
                                       "out": r.linear(c.intermediate, d)},
            "attn_ln": ln(d),
            "attn": {"q": r.linear(d, d), "k": r.linear(d, d),
                     "v": r.linear(d, d), "o": r.linear(d, d),
                     "distance": {"w": r.normal(
                         (c.left_max_position + c.right_max_position + 1,
                          dh), 1.0)}},
            "conv": {"ln": ln(d),
                     "pw1": {"w": r.conv1d(d, 2 * d, 1)["w"]},
                     "dw": {"w": r.conv1d(d, d, c.conv_kernel,
                                          groups=d)["w"]},
                     "dw_ln": ln(d), "pw2": {"w": r.conv1d(d, d, 1)["w"]}},
            "ffn2_ln": ln(d), "ffn2": {"inter": r.linear(d, c.intermediate),
                                       "out": r.linear(c.intermediate, d)},
            "final_ln": ln(d),
        } for _ in range(c.layers)],
        "stats": {"mean": r.uniform((d,), 0.5), "std": r.around_one((d,), 0.5)},
    }


def _codec(r, c) -> Params:
    v, h = c.vocos_dim, c.hidden_size
    return {
        "embed": r.conv1d(h, v, 7), "norm": r.layer_norm(v),
        "blocks": [{"dw": r.conv1d(v, v, 7, groups=v),
                    "norm": r.layer_norm(v),
                    "pw1": r.linear(v, c.vocos_intermediate_dim),
                    "pw2": r.linear(c.vocos_intermediate_dim, v),
                    "gamma": r.uniform((v,), 0.5)}
                   for _ in range(c.vocos_num_layers)],
        "final_norm": r.layer_norm(v), "out": r.linear(v, h),
        "quantizer": {"in_project": r.linear(h, c.codebook_dim),
                      "codebook": {"w": r.normal(
                          (c.codebook_size, c.codebook_dim), 1.0)},
                      "out_project": r.linear(c.codebook_dim, h)},
    }


def _campplus(r, c) -> Params:
    m = c.m_channels
    nobias = lambda q: {"w": q["w"]}
    conv2 = lambda cin, k: nobias(r.conv2d(cin, m, k, k))

    def res(cin, stride):
        p = {"conv1": conv2(cin, 3), "bn1": r.batch_norm(m),
             "conv2": conv2(m, 3), "bn2": r.batch_norm(m)}
        if stride != 1 or cin != m:
            p.update(shortcut=conv2(cin, 1), shortcut_bn=r.batch_norm(m))
        return p

    head = {"conv1": conv2(1, 3), "bn1": r.batch_norm(m),
            "layers": [[res(m, 2), res(m, 1)] for _ in range(2)],
            "conv2": conv2(m, 3), "bn2": r.batch_norm(m)}
    ch = m * (c.feat_dim // 8)
    p: Params = {"head": head,
                 "tdnn": {"conv": nobias(r.conv1d(ch, c.init_channels, 5)),
                          "bn": r.batch_norm(c.init_channels)},
                 "blocks": [], "transits": []}
    ch = c.init_channels
    bn_ch = c.bn_size * c.growth_rate
    for n in c.block_layers:
        block = []
        for i in range(n):
            cin = ch + i * c.growth_rate
            block.append({
                "bn1": r.batch_norm(cin),
                "linear1": nobias(r.conv1d(cin, bn_ch, 1)),
                "bn2": r.batch_norm(bn_ch),
                "cam": {"local": nobias(r.conv1d(bn_ch, c.growth_rate,
                                                 c.kernel)),
                        "linear1": r.conv1d(bn_ch, bn_ch // 2, 1),
                        "linear2": r.conv1d(bn_ch // 2, c.growth_rate, 1)}})
        ch += n * c.growth_rate
        p["blocks"].append(block)
        p["transits"].append({"bn": r.batch_norm(ch),
                              "conv": nobias(r.conv1d(ch, ch // 2, 1))})
        ch //= 2
    p["out_bn"] = r.batch_norm(ch)
    p["dense"] = nobias(r.conv1d(2 * ch, c.embedding_size, 1))
    p["dense_bn"] = r.batch_norm(c.embedding_size)
    return p


def _t_embedder(r, d: int, freq: int) -> Params:
    return {"l1": r.linear(freq, d), "l2": r.linear(d, d)}


def _s2m(r, c) -> Params:
    d, m, h = c.hidden_dim, c.in_channels, c.wavenet_hidden
    ada = lambda: {"proj": r.linear(d, 2 * d), "g": r.ones(d)}
    dims = (c.gpt_dim, *c.gpt_layer, c.regulator_in)
    blocks = []
    for i in range(c.depth):
        b = {"attn_norm": ada(), "ffn_norm": ada(),
             "wqkv": r.linear(d, 3 * d, bias=False),
             "wo": r.linear(d, d, bias=False),
             "w1": r.linear(d, c.intermediate, bias=False),
             "w3": r.linear(d, c.intermediate, bias=False),
             "w2": r.linear(c.intermediate, d, bias=False)}
        if i > c.depth // 2:
            b["skip_in"] = r.linear(2 * d, d)
        blocks.append(b)
    return {
        "gpt_layer": [r.linear(a, b) for a, b in zip(dims[:-1], dims[1:])],
        "regulator": {
            "in_proj": r.linear(c.regulator_in, c.content_dim),
            "blocks": [{"conv": r.conv1d(c.content_dim, c.content_dim, 3),
                        "norm": r.layer_norm(c.content_dim)}
                       for _ in range(c.regulator_blocks)],
            "out": r.conv1d(c.content_dim, c.content_dim, 1)},
        "dit": {
            "t_embed": _t_embedder(r, d, c.time_freq_dim),
            "cond_proj": r.linear(c.content_dim, d),
            "merge": r.linear(d + 2 * m + c.style_dim, d),
            "blocks": blocks, "norm": ada(),
            "skip": r.linear(d + m, d),
            "conv1": r.linear(d, h),
            "t_embed2": _t_embedder(r, h, c.time_freq_dim),
            "wn": {"cond": r.conv1d(h, 2 * h * c.wavenet_layers, 1),
                   "in": [r.conv1d(h, 2 * h, c.wavenet_kernel)
                          for _ in range(c.wavenet_layers)],
                   "res_skip": [r.conv1d(h, 2 * h if i < c.wavenet_layers - 1
                                         else h, 1)
                                for i in range(c.wavenet_layers)]},
            "res_proj": r.linear(d, h),
            "final": {"mod": r.linear(h, 2 * h), "linear": r.linear(h, h)},
            "conv2": r.conv1d(h, m, 1)},
    }


def indextts2_tree(r, cfg) -> Params:
    """IndexTTS-2's tree (``IndexTTS2Config``) from the draws of ``r``
    (an ``Init``, or anything with its methods): {"gpt", "w2vbert",
    "codec", "campplus", "s2m", "vocoder"}. The GPT adds to IndexTTS's
    tree the emotion conditioner (``emo_encoder``, ``emo_perceiver``),
    ``emovec_layer``, ``emo_layer`` and the duration embedding
    ``speed_emb``; the speaker conditioner reads ``cond_input``-wide
    features."""
    g = cfg.gpt
    gpt = init_gpt(r, g, cond_input=cfg.cond_input)
    gpt.update(
        emo_encoder=_conformer(r, cfg.cond_input, cfg.emo_output_size,
                               cfg.emo_attention_heads, cfg.emo_linear_units,
                               cfg.emo_num_blocks),
        emo_perceiver=init_perceiver(r, cfg.emo_dim, cfg.emo_output_size, 1,
                                     64, cfg.emo_attention_heads,
                                     cfg.emo_perceiver_mult),
        emovec_layer=r.linear(cfg.emo_dim, g.model_dim),
        emo_layer=r.linear(g.model_dim, g.model_dim),
        speed_emb={"w": r.normal((2, g.model_dim))})
    return {"gpt": gpt, "w2vbert": _w2vbert(r, cfg.w2vbert),
            "codec": _codec(r, cfg.codec),
            "campplus": _campplus(r, cfg.campplus),
            "s2m": _s2m(r, cfg.s2m), "vocoder": init_bigvgan(r, cfg.vocoder)}


def init_indextts2(cfg, generator: torch.Generator, device="cuda") -> Params:
    """Random IndexTTS-2 parameters (``indextts2_tree``) in float32."""
    return indextts2_tree(Init(generator, device), cfg)
