"""Checkpoint loading in the port against the JAX package.

- ``utils.checkpoint``: the port's save/load round trip, and each package
  reads the other's files;
- ``IndexTTS(model_dir=...)`` on a directory of ``gpt.npz`` +
  ``bigvgan.npz`` written from the JAX package's ``init`` tree, and on one
  of the reference's ``gpt.pth`` + ``bigvgan_generator.pth`` fabricated from
  the same tree (each layout map of ``utils/convert.py`` inverted key by key,
  saved with ``torch.save``): both engines load each directory into trees
  equal leaf for leaf, equal to the tree they were written from, and a
  greedy ``infer_fast`` decodes the same codes on both; the same for a v1.0
  ``gpt.pth`` (the legacy conditioning encoder);
- a leaf whose dtype numpy cannot read (a bfloat16 array saved with
  ``ml_dtypes``) makes the port's engine raise.

Small config of tests/test_torch_engine.py, float32, on the CPU.
"""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.engine.tts import IndexTTS as JaxTTS
from index_tts_dubbing_tpu.models import bigvgan as jbigvgan
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu.utils import checkpoint as jcheckpoint
from index_tts_dubbing_tpu.utils import config as jconfig
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS as PortTTS
from index_tts_dubbing_tpu_torch.utils import checkpoint
from index_tts_dubbing_tpu_torch.utils.audio import write_wav
from tests.test_torch_engine import (BV_SMALL, GPT_SMALL, GREEDY, SPLIT, TEXT,
                                     assert_i16_close)
from tests.test_torch_legacy_cond import GPT_V1, v1_gpt_tree


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process; one torch
    thread runs these small decodes many times faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_config():
    return jconfig.EngineConfig(gpt=jgpt.GPTConfig(**GPT_SMALL),
                                bigvgan=jbigvgan.BigVGANConfig(**BV_SMALL))


def port_config():
    return pconfig.EngineConfig(gpt=pconfig.GPTConfig(**GPT_SMALL),
                                bigvgan=pconfig.BigVGANConfig(**BV_SMALL))


def init_tree():
    """The JAX package's random trees (GPT trunk stacked), as numpy."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    tree = {"gpt": jgpt.init(k1, jgpt.GPTConfig(**GPT_SMALL)),
            "bigvgan": jbigvgan.init(k2, jbigvgan.BigVGANConfig(**BV_SMALL))}
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------- the reference's state-dict layout


def _conv(sd, pfx, p):
    """Ours (K, Cin/g, Cout), or (K, Cout, Cin) transposed → torch (Cout,
    Cin/g, K) or (Cin, Cout, K): the same axis reversal either way."""
    sd[f"{pfx}.weight"] = np.transpose(p["w"], (2, 1, 0))
    if "b" in p:
        sd[f"{pfx}.bias"] = p["b"]


def _linear(sd, pfx, p):
    sd[f"{pfx}.weight"] = np.transpose(p["w"])
    if "b" in p:
        sd[f"{pfx}.bias"] = p["b"]


def _hf_conv1d(sd, pfx, p):      # HF Conv1D keeps (in, out)
    sd[f"{pfx}.weight"], sd[f"{pfx}.bias"] = p["w"], p["b"]


def _ln(sd, pfx, p):
    sd[f"{pfx}.weight"], sd[f"{pfx}.bias"] = p["g"], p["b"]


def _bn(sd, pfx, p):
    sd[f"{pfx}.weight"], sd[f"{pfx}.bias"] = p["g"], p["b"]
    sd[f"{pfx}.running_mean"], sd[f"{pfx}.running_var"] = p["mean"], p["var"]


def legacy_cond_state_dict(sd, pfx, c):
    """A v1.0 ConditioningEncoder's keys (Conv1d init + AttentionBlocks)."""
    _conv(sd, pfx + "init", c["init"])
    for i, blk in enumerate(c["blocks"]):
        b = f"{pfx}attn.{i}"
        _ln(sd, f"{b}.norm", blk["norm"])
        _conv(sd, f"{b}.qkv", blk["qkv"])
        _conv(sd, f"{b}.proj_out", blk["proj"])
        if "rel_pos" in blk:
            sd[f"{b}.relative_pos_embeddings.relative_attention_bias.weight"] \
                = blk["rel_pos"]["emb"]["w"]


def gpt_state_dict(p):
    """gpt.pth's keys (UnifiedVoice + HF GPT2) for a JAX GPT tree (v1.5, or
    v1.0 when its cond_encoder is the legacy one)."""
    sd = {}
    c, pfx = p["cond_encoder"], "conditioning_encoder."
    if "init" in c:
        legacy_cond_state_dict(sd, pfx, c)
    else:
        _conformer_state_dict(sd, pfx, c)
    _rest_state_dict(sd, p)
    return sd


def _conformer_state_dict(sd, pfx, c):
    sd[pfx + "embed.conv.0.weight"] = np.transpose(c["embed"]["conv"]["w"],
                                                   (3, 2, 0, 1))
    sd[pfx + "embed.conv.0.bias"] = c["embed"]["conv"]["b"]
    _linear(sd, pfx + "embed.out.0", c["embed"]["out"])
    for i, blk in enumerate(c["blocks"]):
        b = f"{pfx}encoders.{i}"
        for name in ("norm_mha", "norm_conv", "norm_ff", "norm_final"):
            _ln(sd, f"{b}.{name}", blk[name])
        for ours, ref in (("q", "linear_q"), ("k", "linear_k"),
                          ("v", "linear_v"), ("pos", "linear_pos"),
                          ("out", "linear_out")):
            _linear(sd, f"{b}.self_attn.{ref}", blk["attn"][ours])
        for name in ("pos_bias_u", "pos_bias_v"):
            sd[f"{b}.self_attn.{name}"] = blk["attn"][name]
        for ours, ref in (("pw1", "pointwise_conv1"), ("dw", "depthwise_conv"),
                          ("pw2", "pointwise_conv2")):
            _conv(sd, f"{b}.conv_module.{ref}", blk["conv"][ours])
        _ln(sd, f"{b}.conv_module.norm", blk["conv"]["ln"])
        _linear(sd, f"{b}.feed_forward.w_1", blk["ff"]["w1"])
        _linear(sd, f"{b}.feed_forward.w_2", blk["ff"]["w2"])
    _ln(sd, pfx + "after_norm", c["after_norm"])


def _rest_state_dict(sd, p):
    per, pfx = p["perceiver"], "perceiver_encoder."
    sd[pfx + "latents"] = per["latents"]
    sd[pfx + "norm.gamma"] = per["norm"]["g"]
    _linear(sd, pfx + "proj_context", per["proj_context"])
    for i, layer in enumerate(per["layers"]):
        for name in ("to_q", "to_kv", "to_out"):
            _linear(sd, f"{pfx}layers.{i}.0.{name}", layer["attn"][name])
        _linear(sd, f"{pfx}layers.{i}.1.0", layer["ff"]["w1"])
        _linear(sd, f"{pfx}layers.{i}.1.2", layer["ff"]["w2"])
    sd["text_embedding.weight"] = p["text_emb"]["w"]
    sd["mel_embedding.weight"] = p["mel_emb"]["w"]
    sd["text_pos_embedding.emb.weight"] = p["text_pos"]["w"]
    sd["mel_pos_embedding.emb.weight"] = p["mel_pos"]["w"]
    blocks = p["blocks"]             # stacked: every leaf leads with layers
    for i in range(len(blocks["ln1"]["g"])):
        blk = jax.tree_util.tree_map(lambda x: x[i], blocks)
        b = f"gpt.h.{i}"
        _ln(sd, f"{b}.ln_1", blk["ln1"])
        _ln(sd, f"{b}.ln_2", blk["ln2"])
        _hf_conv1d(sd, f"{b}.attn.c_attn", blk["attn"]["qkv"])
        _hf_conv1d(sd, f"{b}.attn.c_proj", blk["attn"]["proj"])
        _hf_conv1d(sd, f"{b}.mlp.c_fc", blk["mlp"]["fc"])
        _hf_conv1d(sd, f"{b}.mlp.c_proj", blk["mlp"]["proj"])
    _ln(sd, "gpt.ln_f", p["ln_f"])
    _ln(sd, "final_norm", p["final_norm"])
    _linear(sd, "text_head", p["text_head"])
    _linear(sd, "mel_head", p["mel_head"])


def _tdnn(sd, pfx, p):
    _conv(sd, f"{pfx}.conv.conv", p["conv"])
    _bn(sd, f"{pfx}.norm.norm", p["bn"])


def bigvgan_state_dict(p):
    """bigvgan_generator.pth's keys (BigVGAN + ECAPA speaker encoder)."""
    sd = {}
    _conv(sd, "conv_pre", p["conv_pre"])
    for i, up in enumerate(p["ups"]):
        _conv(sd, f"ups.{i}.0", up)
    for i, rb in enumerate(p["resblocks"]):
        for j in range(3):
            _conv(sd, f"resblocks.{i}.convs1.{j}", rb["convs1"][j])
            _conv(sd, f"resblocks.{i}.convs2.{j}", rb["convs2"][j])
        for j, act in enumerate(rb["acts"]):
            for name, val in act.items():
                sd[f"resblocks.{i}.activations.{j}.act.{name}"] = val
    for name, val in p["act_post"].items():
        sd[f"activation_post.act.{name}"] = val
    _conv(sd, "conv_post", p["conv_post"])
    _conv(sd, "cond_layer", p["cond_layer"])
    for i, cond in enumerate(p["conds"]):
        _conv(sd, f"conds.{i}", cond)
    e, pfx = p["speaker_encoder"], "speaker_encoder."
    _tdnn(sd, pfx + "blocks.0", e["blocks"][0])
    for i, blk in enumerate(e["blocks"][1:], start=1):
        b = f"{pfx}blocks.{i}"
        _tdnn(sd, f"{b}.tdnn1", blk["tdnn1"])
        for j, r in enumerate(blk["res2net"]["blocks"]):
            _tdnn(sd, f"{b}.res2net_block.blocks.{j}", r)
        _tdnn(sd, f"{b}.tdnn2", blk["tdnn2"])
        _conv(sd, f"{b}.se_block.conv1.conv", blk["se"]["conv1"])
        _conv(sd, f"{b}.se_block.conv2.conv", blk["se"]["conv2"])
    _tdnn(sd, pfx + "mfa", e["mfa"])
    _tdnn(sd, pfx + "asp.tdnn", e["asp"]["tdnn"])
    _conv(sd, pfx + "asp.conv.conv", e["asp"]["conv"])
    _bn(sd, pfx + "asp_bn.norm", e["asp_bn"])
    _conv(sd, pfx + "fc.conv", e["fc"])
    return sd


def _tensors(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def write_model_dir(path, tree, fmt):
    """``tree`` as the engine's .npz pair or as the reference's .pth pair
    (the generator's under the "generator" key, as BigVGAN saves it)."""
    path.mkdir(parents=True, exist_ok=True)
    if fmt == "npz":
        checkpoint.save_params(path / "gpt.npz", tree["gpt"])
        checkpoint.save_params(path / "bigvgan.npz", tree["bigvgan"])
    else:
        torch.save(_tensors(gpt_state_dict(tree["gpt"])), path / "gpt.pth")
        torch.save({"generator": _tensors(bigvgan_state_dict(tree["bigvgan"]))},
                   path / "bigvgan_generator.pth")
    return path


def assert_trees_equal(a, b, path="params"):
    """Tensor trees: the same structure, dtypes and values."""
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (path, set(a) ^ set(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


# ------------------------------------------------------------------ tests


def test_save_load_round_trip(tmp_path):
    """Nested dicts and lists survive the port's save/load; the JAX package
    reads the port's file and the port reads the JAX package's."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "blocks": [{"w": rng.standard_normal(5).astype(np.float32),
                        "n": np.arange(3, dtype=np.int32)} for _ in range(12)],
            "nested": {"x": {"y": np.float16(2.5) * np.ones(2, np.float16)}}}
    flat = checkpoint.flatten_tree(tree)
    assert "blocks/11/w" in flat and "nested/x/y" in flat
    checkpoint.save_params(tmp_path / "port.npz", tree)
    jcheckpoint.save_params(tmp_path / "jax.npz", tree)
    for got in (checkpoint.load_params(tmp_path / "port.npz"),
                checkpoint.load_params(tmp_path / "jax.npz"),
                jcheckpoint.load_params(tmp_path / "port.npz")):
        assert isinstance(got["blocks"], list) and len(got["blocks"]) == 12
        got_flat = checkpoint.flatten_tree(got)
        assert got_flat.keys() == flat.keys()
        for k, v in flat.items():
            assert got_flat[k].dtype == v.dtype
            np.testing.assert_array_equal(got_flat[k], v)


@pytest.fixture(scope="module")
def tree_and_prompt(tmp_path_factory):
    """The JAX package's random tree and a random 1 s prompt."""
    prompt = tmp_path_factory.mktemp("ckpt") / "prompt.wav"
    rng = np.random.default_rng(1)
    write_wav(prompt, (rng.standard_normal(24000) * 0.1).astype(np.float32),
              24000)
    return init_tree(), str(prompt)


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_model_dir_loads_in_both_engines(tree_and_prompt, tmp_path, fmt):
    """Both engines load one model directory into equal trees, equal to the
    tree it was written from, and decode the same greedy codes."""
    tree, prompt = tree_and_prompt
    model_dir = write_model_dir(tmp_path / fmt, tree, fmt)
    jeng = JaxTTS(config=jax_config(), model_dir=str(model_dir),
                  verbose_init=False)
    peng = PortTTS(config=port_config(), model_dir=str(model_dir),
                   device="cpu", verbose_init=False)
    want = weights.from_jax_params(tree, device="cpu")
    assert_trees_equal(peng.params, want)
    assert_trees_equal(weights.from_jax_params(jeng.params, device="cpu"), want)
    kw = dict(GREEDY, max_mel_tokens=48, **SPLIT)
    jsr, jwav = jeng.infer_fast(prompt, TEXT, **dict(kw))
    psr, pwav = peng.infer_fast(prompt, TEXT, **dict(kw))
    assert jsr == psr == 24000
    np.testing.assert_array_equal(peng.last_fused_res.codes.numpy(),
                                  np.asarray(jeng.last_fused_res.codes))
    assert_i16_close(pwav, jwav)


def test_v1_pth_loads_in_both_engines(tree_and_prompt, tmp_path):
    """A v1.0 gpt.pth (conditioning_encoder.init.weight present: the legacy
    encoder, one block with relative positions) loads through
    IndexTTS(model_dir=) in both engines into equal trees, equal to the
    tree it was written from, and a greedy infer_fast decodes the same
    codes on both."""
    _, prompt = tree_and_prompt
    k1, k2 = jax.random.split(jax.random.PRNGKey(8))
    tree = {"gpt": v1_gpt_tree(k1, GPT_V1),
            "bigvgan": jax.tree_util.tree_map(np.asarray, jbigvgan.init(
                k2, jbigvgan.BigVGANConfig(**BV_SMALL)))}
    model_dir = write_model_dir(tmp_path / "v1", tree, "pth")
    sd = torch.load(model_dir / "gpt.pth")
    assert "conditioning_encoder.init.weight" in sd
    jeng = JaxTTS(config=jconfig.EngineConfig(
        gpt=jgpt.GPTConfig(**GPT_V1), bigvgan=jbigvgan.BigVGANConfig(
            **BV_SMALL)), model_dir=str(model_dir), verbose_init=False)
    peng = PortTTS(config=pconfig.EngineConfig(
        gpt=pconfig.GPTConfig(**GPT_V1), bigvgan=pconfig.BigVGANConfig(
            **BV_SMALL)), model_dir=str(model_dir), device="cpu",
        verbose_init=False)
    want = weights.from_jax_params(tree, device="cpu")
    assert "init" in peng.params["gpt"]["cond_encoder"]
    assert_trees_equal(peng.params, want)
    assert_trees_equal(weights.from_jax_params(jeng.params, device="cpu"), want)
    kw = dict(GREEDY, max_mel_tokens=48, **SPLIT)
    jsr, jwav = jeng.infer_fast(prompt, TEXT, **dict(kw))
    psr, pwav = peng.infer_fast(prompt, TEXT, **dict(kw))
    np.testing.assert_array_equal(peng.last_fused_res.codes.numpy(),
                                  np.asarray(jeng.last_fused_res.codes))
    assert_i16_close(pwav, jwav)


def test_npz_with_unreadable_leaf_dtype_raises(tmp_path):
    """A bfloat16 leaf saved by numpy with ml_dtypes reads back as two-byte
    voids: the port's engine refuses it, naming the leaf."""
    tree = init_tree()
    tree["gpt"]["ln_f"]["g"] = tree["gpt"]["ln_f"]["g"].astype(
        ml_dtypes.bfloat16)
    model_dir = write_model_dir(tmp_path, tree, "npz")
    assert checkpoint.load_params(model_dir / "gpt.npz")["ln_f"]["g"].dtype \
        == np.dtype("V2")
    with pytest.raises(ValueError, match="ln_f/g"):
        PortTTS(config=port_config(), model_dir=str(model_dir), device="cpu",
                verbose_init=False)
