"""Torch checkpoint → parameter-tree conversion.

Conversion of the reference's three checkpoints (gpt.pth,
bigvgan_generator.pth, dvae.pth — config.yaml:111-113) into the engine's
parameter trees (the JAX package's layout, which ``weights.from_jax_params``
takes), including weight-norm folding (g·v/‖v‖ → plain kernels,
matching torch remove_weight_norm semantics used at BigVGAN eval,
BigVGAN/models.py:252-260).

Works on "state dicts" = flat {name: numpy array}; ``load_torch_state_dict``
produces one from a .pth file when torch is importable, so the heavy torch
dependency is confined to conversion time.

A copy of the JAX package's ``utils/convert.py``; only the imports of
``models.ecapa`` and ``models.conformer`` point at the port's own modules.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

Array = np.ndarray
StateDict = Mapping[str, Array]


def load_torch_state_dict(path: str) -> Dict[str, Array]:
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("model", "generator", "state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in obj.items()}


def torch_module_state_dict(module) -> Dict[str, Array]:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


# --- primitive weight layout maps -----------------------------------------

def conv1d_w(w: Array) -> Array:
    """torch (Cout, Cin/g, K) → ours (K, Cin/g, Cout)."""
    return np.transpose(w, (2, 1, 0)).copy()


def conv2d_w(w: Array) -> Array:
    """torch (Cout, Cin, Kh, Kw) → ours (Kh, Kw, Cin, Cout)."""
    return np.transpose(w, (2, 3, 1, 0)).copy()


def conv_transpose1d_w(w: Array) -> Array:
    """torch (Cin, Cout, K) → ours (K, Cout, Cin)."""
    return np.transpose(w, (2, 1, 0)).copy()


def linear_w(w: Array) -> Array:
    """torch (Cout, Cin) → ours (Cin, Cout)."""
    return np.transpose(w).copy()


def fold_weight_norm(sd: StateDict, prefix: str) -> Array:
    """Return the plain torch-layout weight for ``prefix`` whether or not it is
    weight-normed in the state dict (handles both parametrized and legacy
    weight_g/weight_v naming)."""
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"]
    for gk, vk in ((f"{prefix}.weight_g", f"{prefix}.weight_v"),
                   (f"{prefix}.parametrizations.weight.original0",
                    f"{prefix}.parametrizations.weight.original1")):
        if gk in sd:
            g, v = sd[gk], sd[vk]
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(np.square(v), axis=axes, keepdims=True))
            return (g * v / norm).astype(v.dtype)
    raise KeyError(f"no weight found for {prefix}")


def _conv(sd: StateDict, prefix: str, transposed: bool = False) -> Dict[str, Array]:
    w = fold_weight_norm(sd, prefix)
    w = conv_transpose1d_w(w) if transposed else conv1d_w(w)
    p = {"w": w}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _linear(sd: StateDict, prefix: str) -> Dict[str, Array]:
    p = {"w": linear_w(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _bn(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return {"g": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"],
            "mean": sd[f"{prefix}.running_mean"],
            "var": sd[f"{prefix}.running_var"]}


def _ln(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return {"g": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"]}


# --- ECAPA-TDNN ------------------------------------------------------------

def convert_ecapa(sd: StateDict, prefix: str = "") -> Dict[str, Any]:
    """Reference ECAPA_TDNN state dict → models/ecapa.py param tree.
    Layer map per ECAPA_TDNN.py:470-541."""
    from index_tts_dubbing_tpu_torch.models.ecapa import (CHANNELS,
                                                          RES2NET_SCALE)

    def tdnn(pfx):
        return {"conv": _conv(sd, f"{pfx}.conv.conv"),
                "bn": _bn(sd, f"{pfx}.norm.norm")}

    p: Dict[str, Any] = {"blocks": []}
    p["blocks"].append(tdnn(f"{prefix}blocks.0"))
    for i in range(1, len(CHANNELS) - 1):
        b = f"{prefix}blocks.{i}"
        p["blocks"].append({
            "tdnn1": tdnn(f"{b}.tdnn1"),
            "res2net": {"blocks": [tdnn(f"{b}.res2net_block.blocks.{j}")
                                   for j in range(RES2NET_SCALE - 1)]},
            "tdnn2": tdnn(f"{b}.tdnn2"),
            "se": {"conv1": _conv(sd, f"{b}.se_block.conv1.conv"),
                   "conv2": _conv(sd, f"{b}.se_block.conv2.conv")},
        })
    p["mfa"] = tdnn(f"{prefix}mfa")
    p["asp"] = {"tdnn": tdnn(f"{prefix}asp.tdnn"),
                "conv": _conv(sd, f"{prefix}asp.conv.conv")}
    p["asp_bn"] = _bn(sd, f"{prefix}asp_bn.norm")
    p["fc"] = _conv(sd, f"{prefix}fc.conv")
    return p


# --- Conformer encoder ------------------------------------------------------

def convert_conformer(sd: StateDict, num_blocks: int = 6,
                      prefix: str = "") -> Dict[str, Any]:
    """Reference ConformerEncoder state dict → models/conformer.py tree.
    Layer map per gpt/conformer_encoder.py:316-521."""
    from index_tts_dubbing_tpu_torch.models.conformer import sinusoidal_pos

    odim = sd[f"{prefix}embed.conv.0.weight"].shape[0]
    p: Dict[str, Any] = {
        "embed": {
            "conv": {"w": conv2d_w(sd[f"{prefix}embed.conv.0.weight"]),
                     "b": sd[f"{prefix}embed.conv.0.bias"]},
            "out": _linear(sd, f"{prefix}embed.out.0"),
        },
        "pe": sinusoidal_pos(5000, odim),
        "blocks": [],
        "after_norm": _ln(sd, f"{prefix}after_norm"),
    }
    for i in range(num_blocks):
        b = f"{prefix}encoders.{i}"
        p["blocks"].append({
            "norm_mha": _ln(sd, f"{b}.norm_mha"),
            "attn": {
                "q": _linear(sd, f"{b}.self_attn.linear_q"),
                "k": _linear(sd, f"{b}.self_attn.linear_k"),
                "v": _linear(sd, f"{b}.self_attn.linear_v"),
                "pos": _linear(sd, f"{b}.self_attn.linear_pos"),
                "out": _linear(sd, f"{b}.self_attn.linear_out"),
                "pos_bias_u": sd[f"{b}.self_attn.pos_bias_u"],
                "pos_bias_v": sd[f"{b}.self_attn.pos_bias_v"],
            },
            "norm_conv": _ln(sd, f"{b}.norm_conv"),
            "conv": {
                "pw1": _conv(sd, f"{b}.conv_module.pointwise_conv1"),
                "dw": _conv(sd, f"{b}.conv_module.depthwise_conv"),
                "ln": _ln(sd, f"{b}.conv_module.norm"),
                "pw2": _conv(sd, f"{b}.conv_module.pointwise_conv2"),
            },
            "norm_ff": _ln(sd, f"{b}.norm_ff"),
            "ff": {"w1": _linear(sd, f"{b}.feed_forward.w_1"),
                   "w2": _linear(sd, f"{b}.feed_forward.w_2")},
            "norm_final": _ln(sd, f"{b}.norm_final"),
        })
    return p


# --- Perceiver resampler ----------------------------------------------------

def convert_perceiver(sd: StateDict, depth: int = 2,
                      prefix: str = "") -> Dict[str, Any]:
    """Reference PerceiverResampler state dict → models/perceiver.py tree.
    Layer map per gpt/perceiver.py:224-317."""
    p: Dict[str, Any] = {
        "latents": sd[f"{prefix}latents"],
        "norm": {"g": sd[f"{prefix}norm.gamma"]},
        "layers": [],
    }
    if f"{prefix}proj_context.weight" in sd:
        p["proj_context"] = _linear(sd, f"{prefix}proj_context")
    for i in range(depth):
        b = f"{prefix}layers.{i}"
        p["layers"].append({
            "attn": {
                "to_q": _linear(sd, f"{b}.0.to_q"),
                "to_kv": _linear(sd, f"{b}.0.to_kv"),
                "to_out": _linear(sd, f"{b}.0.to_out"),
            },
            "ff": {"w1": _linear(sd, f"{b}.1.0"),
                   "w2": _linear(sd, f"{b}.1.2")},
        })
    return p


# --- Legacy conditioning encoder (v1.0) -------------------------------------

def convert_legacy_cond(sd: StateDict, attn_blocks: int = 6,
                        prefix: str = "") -> Dict[str, Any]:
    """Reference ConditioningEncoder (gpt/model.py:210-235 + arch_util
    AttentionBlock) → models/legacy_cond.py tree."""
    p: Dict[str, Any] = {"init": _conv(sd, f"{prefix}init"), "blocks": []}
    for i in range(attn_blocks):
        b = f"{prefix}attn.{i}"
        blk = {"norm": _ln(sd, f"{b}.norm"),
               "qkv": _conv(sd, f"{b}.qkv"),
               "proj": _conv(sd, f"{b}.proj_out")}
        if f"{b}.relative_pos_embeddings.relative_attention_bias.weight" in sd:
            blk["rel_pos"] = {"emb": {"w": sd[
                f"{b}.relative_pos_embeddings.relative_attention_bias.weight"]}}
        p["blocks"].append(blk)
    return p


# --- UnifiedVoice GPT -------------------------------------------------------

def convert_unified_voice(sd: StateDict, layers: int = 20,
                          cond_blocks: int = 6) -> Dict[str, Any]:
    """Reference UnifiedVoice (gpt.pth) state dict → models/gpt.py param tree.
    Layer map per gpt/model.py:300-386 + HF GPT2Model (Conv1D weights are
    already (in, out), so they map to our linear layout without transpose)."""
    def conv1d_linear(prefix):  # HF Conv1D: weight (in, out)
        return {"w": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"]}

    if "conditioning_encoder.init.weight" in sd:  # v1.0 legacy encoder
        cond = convert_legacy_cond(sd, attn_blocks=cond_blocks,
                                   prefix="conditioning_encoder.")
    else:
        cond = convert_conformer(sd, num_blocks=cond_blocks,
                                 prefix="conditioning_encoder.")
    p: Dict[str, Any] = {
        "cond_encoder": cond,
        "perceiver": convert_perceiver(sd, prefix="perceiver_encoder."),
        "text_emb": {"w": sd["text_embedding.weight"]},
        "mel_emb": {"w": sd["mel_embedding.weight"]},
        "text_pos": {"w": sd["text_pos_embedding.emb.weight"]},
        "mel_pos": {"w": sd["mel_pos_embedding.emb.weight"]},
        "blocks": [],
        "ln_f": _ln(sd, "gpt.ln_f"),
        "final_norm": _ln(sd, "final_norm"),
        "text_head": _linear(sd, "text_head"),
        "mel_head": _linear(sd, "mel_head"),
    }
    for i in range(layers):
        b = f"gpt.h.{i}"
        p["blocks"].append({
            "ln1": _ln(sd, f"{b}.ln_1"),
            "attn": {"qkv": conv1d_linear(f"{b}.attn.c_attn"),
                     "proj": conv1d_linear(f"{b}.attn.c_proj")},
            "ln2": _ln(sd, f"{b}.ln_2"),
            "mlp": {"fc": conv1d_linear(f"{b}.mlp.c_fc"),
                    "proj": conv1d_linear(f"{b}.mlp.c_proj")},
        })
    return p


# --- DVAE -------------------------------------------------------------------

def convert_dvae(sd: StateDict, num_layers: int = 2,
                 num_resnet_blocks: int = 3) -> Dict[str, Any]:
    """Reference DiscreteVAE state dict (dvae.pth) → models/dvae.py param
    tree. Layer map per vqvae/xtts_dvae.py:201-320 at the IndexTTS config
    (config.yaml:39-49): encoder = [conv-act]×L → ResBlock×R → 1×1 conv;
    decoder = 1×1 conv → ResBlock×R → [nearest-×2-upsample conv-act]×L →
    1×1 conv (use_transposed_convs: false); EMA codebook ``codebook.embed``.
    """
    def conv(prefix):
        p = {"w": conv1d_w(sd[f"{prefix}.weight"])}
        if f"{prefix}.bias" in sd:
            p["b"] = sd[f"{prefix}.bias"]
        return p

    def res(base):
        return {"c1": conv(f"{base}.0"), "c2": conv(f"{base}.2"),
                "c3": conv(f"{base}.4")}

    p: Dict[str, Any] = {
        "enc_convs": [conv(f"encoder.{i}.0") for i in range(num_layers)],
        "enc_res": [res(f"encoder.{num_layers + i}.net")
                    for i in range(num_resnet_blocks)],
        "enc_out": conv(f"encoder.{num_layers + num_resnet_blocks}"),
        "dec_in": conv("decoder.0"),
        "dec_res": [res(f"decoder.{1 + i}.net")
                    for i in range(num_resnet_blocks)],
        "dec_convs": [conv(f"decoder.{1 + num_resnet_blocks + i}.0.conv")
                      for i in range(num_layers)],
        "dec_out": conv(f"decoder.{1 + num_resnet_blocks + num_layers}"),
        "codebook": {"embed": sd["codebook.embed"]},
    }
    return p


# --- BigVGAN generator ------------------------------------------------------

def convert_bigvgan(sd: StateDict, num_upsamples: int = 6,
                    num_kernels: int = 3) -> Dict[str, Any]:
    """Reference BigVGAN generator state dict → models/bigvgan.py param tree.
    Layer map per BigVGAN/models.py:130-199."""
    p: Dict[str, Any] = {}
    p["conv_pre"] = _conv(sd, "conv_pre")
    p["ups"] = [_conv(sd, f"ups.{i}.0", transposed=True)
                for i in range(num_upsamples)]
    p["resblocks"] = []
    for i in range(num_upsamples * num_kernels):
        rb = {
            "convs1": [_conv(sd, f"resblocks.{i}.convs1.{j}") for j in range(3)],
            "convs2": [_conv(sd, f"resblocks.{i}.convs2.{j}") for j in range(3)],
            "acts": [],
        }
        for j in range(6):
            a = {"alpha": sd[f"resblocks.{i}.activations.{j}.act.alpha"]}
            bkey = f"resblocks.{i}.activations.{j}.act.beta"
            if bkey in sd:
                a["beta"] = sd[bkey]
            rb["acts"].append(a)
        p["resblocks"].append(rb)
    a = {"alpha": sd["activation_post.act.alpha"]}
    if "activation_post.act.beta" in sd:
        a["beta"] = sd["activation_post.act.beta"]
    p["act_post"] = a
    p["conv_post"] = _conv(sd, "conv_post")
    p["cond_layer"] = _conv(sd, "cond_layer")
    p["conds"] = [_conv(sd, f"conds.{i}") for i in range(num_upsamples)]
    p["speaker_encoder"] = convert_ecapa(sd, "speaker_encoder.")
    return p
