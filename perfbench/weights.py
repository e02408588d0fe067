"""Random weights from the seed, made by the benchmark and handed to both
the program and the reference.

The tree has the port's layout and IndexTTS's shapes and distributions
(torch's default inits: uniform fan-in bounds for linear and conv layers,
N(0, 0.02) for embeddings and the GPT trunk; norms at one and zero, snake
α and β at zero in log scale). It is drawn on the device in two calls, one
uniform and one normal buffer, and every leaf is a scaled slice of one of
them, in the dtype the configuration serves.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from perfbench.reference import conformer, ecapa

Params = Dict[str, Any]


class _Draw:
    """A leaf to fill later: ``kind`` "u" (uniform in ±scale) or "n"
    (normal with std ``scale``)."""

    def __init__(self, kind: str, shape: Tuple[int, ...], scale: float):
        self.kind, self.shape, self.scale = kind, tuple(shape), scale


class _Spec:
    """The port's ``weights.Init`` with every draw deferred."""

    def uniform(self, shape, bound: float) -> _Draw:
        return _Draw("u", shape, bound)

    def normal(self, shape, std: float = 0.02) -> _Draw:
        return _Draw("n", shape, std)

    def ones(self, n):
        return ("ones", n)

    def zeros(self, n):
        return ("zeros", n)

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


def _conformer(r: _Spec, input_size: int, d: int, heads: int, units: int,
               num_blocks: int, cnn_kernel: int = 15, max_len: int = 5000
               ) -> Params:
    dk = d // heads
    xavier = math.sqrt(6.0 / (heads * dk + dk))
    p: Params = {
        "embed": {"conv": r.conv2d(1, d, 3, 3),
                  "out": r.linear(d * ((input_size - 1) // 2), d)},
        "pe": ("const", conformer.sinusoidal_pos(max_len, d)),
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


def _perceiver(r: _Spec, dim: int, dim_context: int, num_latents: int,
               dim_head: int, heads: int, ff_mult: int, depth: int = 2
               ) -> Params:
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


def _gpt(r: _Spec, g: Dict[str, Any]) -> Params:
    d = g["model_dim"]
    max_text_seq = g["max_text_tokens"] + 2
    max_mel_seq = g["max_mel_tokens"] + 3
    return {
        "cond_encoder": _conformer(r, 100, g["cond_output_size"],
                                   g["cond_attention_heads"],
                                   g["cond_linear_units"],
                                   g["cond_num_blocks"]),
        "perceiver": _perceiver(r, d, g["cond_output_size"],
                                g["condition_num_latent"], 64,
                                g["cond_attention_heads"],
                                g["perceiver_mult"]),
        "text_emb": {"w": r.normal((g["number_text_tokens"] + 1, d))},
        "mel_emb": {"w": r.normal((g["number_mel_codes"], d))},
        "text_pos": {"w": r.normal((max_text_seq, d))},
        "mel_pos": {"w": r.normal((max_mel_seq, d))},
        "blocks": [{
            "ln1": r.layer_norm(d),
            "attn": {"qkv": {"w": r.normal((d, 3 * d)), "b": r.zeros(3 * d)},
                     "proj": {"w": r.normal((d, d)), "b": r.zeros(d)}},
            "ln2": r.layer_norm(d),
            "mlp": {"fc": {"w": r.normal((d, 4 * d)), "b": r.zeros(4 * d)},
                    "proj": {"w": r.normal((4 * d, d)), "b": r.zeros(d)}},
        } for _ in range(g["layers"])],
        "ln_f": r.layer_norm(d),
        "final_norm": r.layer_norm(d),
        "text_head": r.linear(d, g["number_text_tokens"] + 1),
        "mel_head": r.linear(d, g["number_mel_codes"]),
    }


def _tdnn(r: _Spec, cin: int, cout: int, k: int) -> Params:
    return {"conv": r.conv1d(cin, cout, k), "bn": r.batch_norm(cout)}


def _ecapa(r: _Spec, input_size: int, lin_neurons: int) -> Params:
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


def _bigvgan(r: _Spec, b: Dict[str, Any]) -> Params:
    rates, kups = b["upsample_rates"], b["upsample_kernel_sizes"]
    ch0 = b["upsample_initial_channel"]
    snake = lambda ch: ({"alpha": r.zeros(ch), "beta": r.zeros(ch)}
                        if b["activation"] == "snakebeta"
                        else {"alpha": r.zeros(ch)})
    p: Params = {"conv_pre": r.conv1d(b["gpt_dim"], ch0, 7),
                 "ups": [], "resblocks": [], "conds": []}
    ch_in = ch0
    for i in range(len(rates)):
        ch = ch0 // (2 ** (i + 1))
        p["ups"].append(r.conv_transpose1d(ch_in, ch, kups[i]))
        for k in b["resblock_kernel_sizes"]:
            p["resblocks"].append({
                "convs1": [r.conv1d(ch, ch, k) for _ in range(3)],
                "convs2": [r.conv1d(ch, ch, k) for _ in range(3)],
                "acts": [snake(ch) for _ in range(6)],
            })
        p["conds"].append(r.conv1d(b["speaker_embedding_dim"], ch, 1))
        ch_in = ch
    p["act_post"] = snake(ch_in)
    p["conv_post"] = r.conv1d(ch_in, 1, 7)
    p["cond_layer"] = r.conv1d(b["speaker_embedding_dim"], ch0, 1)
    p["speaker_encoder"] = _ecapa(r, b["num_mels"], b["speaker_embedding_dim"])
    return p


def _leaves(tree, out: List[_Draw]) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, _Draw):
        out.append(tree)


def make(cfg: Dict[str, Any], seed: int, device, dtype: torch.dtype
         ) -> Params:
    """{"gpt", "bigvgan"} for the configuration file's ``gpt`` and
    ``bigvgan`` sections, drawn from ``seed`` on ``device`` in ``dtype``."""
    spec = {"gpt": _gpt(_Spec(), cfg["gpt"]),
            "bigvgan": _bigvgan(_Spec(), cfg["bigvgan"])}
    draws: List[_Draw] = []
    _leaves(spec, draws)
    gen = torch.Generator(device).manual_seed(int(seed))
    sizes = {k: sum(math.prod(d.shape) for d in draws if d.kind == k)
             for k in ("u", "n")}
    bufs = {"u": torch.rand(sizes["u"], generator=gen, device=device),
            "n": torch.randn(sizes["n"], generator=gen, device=device)}
    offs = {"u": 0, "n": 0}

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v) for v in tree]
        if isinstance(tree, _Draw):
            n = math.prod(tree.shape)
            o = offs[tree.kind]
            offs[tree.kind] = o + n
            x = bufs[tree.kind][o: o + n].view(tree.shape)
            x = (x * 2.0 - 1.0) * tree.scale if tree.kind == "u" \
                else x * tree.scale
            return x.to(dtype)
        kind, val = tree
        if kind == "const":
            return torch.as_tensor(val, device=device).to(dtype)
        fn = torch.ones if kind == "ones" else torch.zeros
        return fn(val, device=device, dtype=dtype)

    params = fill(spec)
    del bufs
    return params


def cast(tree, dtype: torch.dtype):
    """Every floating leaf of a tree cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree
