"""The v1.0 conditioning (index_tts_dubbing_tpu_torch/models/legacy_cond.py
and ``get_conditioning`` for ``condition_type == "perceiver"``) against the
JAX package's models/legacy_cond.py and models/gpt.py, on the CPU in
float32:

- ``norm_groups`` and ``relative_position_bucket`` exact;
- ``attention_block`` and ``forward`` within 2e-5, with every block's
  ``proj`` random (the init zeroes it, which would make a block the
  identity) and a random ``rel_pos`` on one block;
- ``get_conditioning`` of a v1.0 tree within 2e-5;
- greedy ``infer_fast`` on both engines from one v1.0 JAX tree: codes
  token-exact, the int16 wav within 2 LSB.

A v1.0 tree is built as ``utils/convert.py`` builds it from a v1.0 ``.pth``:
the legacy encoder (JAX ``legacy_cond.init``) in place of the conformer, and
the perceiver with ``dim_context = model_dim``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.engine.tts import IndexTTS as JaxTTS
from index_tts_dubbing_tpu.models import bigvgan as jbigvgan
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu.models import legacy_cond as jlegacy
from index_tts_dubbing_tpu.models import perceiver as jperceiver
from index_tts_dubbing_tpu.utils import config as jconfig
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS as PortTTS
from index_tts_dubbing_tpu_torch.models import gpt as pgpt
from index_tts_dubbing_tpu_torch.models import legacy_cond as plegacy
from tests.test_torch_engine import (BV_SMALL, GPT_SMALL, GREEDY, SPLIT, TEXT,
                                     assert_i16_close)

GPT_V1 = dict(GPT_SMALL, condition_type="perceiver")
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process; one torch
    thread runs these small decodes many times faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomised_legacy(key, spec_dim, dim, blocks, heads):
    """JAX ``legacy_cond.init`` with every ``proj`` drawn N(0, 0.02) and a
    random ``rel_pos`` table (32 buckets × heads) on the first block."""
    p = jax.tree.map(np.asarray, jlegacy.init(key, spec_dim, dim, blocks,
                                              heads))
    rng = np.random.default_rng(11)
    for blk in p["blocks"]:
        blk["proj"] = {"w": (rng.standard_normal(blk["proj"]["w"].shape)
                             * 0.02).astype(np.float32),
                       "b": (rng.standard_normal(dim) * 0.02
                             ).astype(np.float32)}
    p["blocks"][0]["rel_pos"] = {"emb": {"w": (
        rng.standard_normal((32, heads)) * 0.5).astype(np.float32)}}
    return p


def v1_gpt_tree(key, gpt_kwargs):
    """A v1.0 GPT tree: JAX ``gpt.init`` with the legacy encoder in place of
    the conformer and the perceiver over ``model_dim`` contexts."""
    cfg = jgpt.GPTConfig(**gpt_kwargs)
    k1, k2, k3 = jax.random.split(key, 3)
    tree = jax.tree.map(np.asarray, jgpt.init(k1, cfg))
    d = cfg.model_dim
    tree["cond_encoder"] = randomised_legacy(k2, 100, d, cfg.cond_num_blocks,
                                             cfg.heads)
    tree["perceiver"] = jax.tree.map(np.asarray, jperceiver.init(
        k3, d, d, cfg.condition_num_latent, 64, cfg.cond_attention_heads,
        cfg.perceiver_mult))
    return tree


def test_norm_groups_and_buckets_are_exact():
    for c in (8, 12, 16, 24, 48, 64, 96, 100, 128, 512, 1024):
        assert plegacy.norm_groups(c) == jlegacy.norm_groups(c)
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 200)[:, None]
    for nb, md in ((32, 64), (16, 128)):
        want = np.asarray(jlegacy.relative_position_bucket(jnp.asarray(rel),
                                                           nb, md))
        got = plegacy.relative_position_bucket(torch.from_numpy(rel), nb, md)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rel_pos", [False, True])
def test_attention_block_matches_jax(rng, rel_pos):
    c, h = 64, 4
    p = randomised_legacy(jax.random.PRNGKey(3), 100, c, 1, h)["blocks"][0]
    if not rel_pos:
        del p["rel_pos"]
    x = rng.standard_normal((2, 40, c)).astype(np.float32)
    want = np.asarray(jlegacy.attention_block(p, jnp.asarray(x), h,
                                              p.get("rel_pos")))
    pp = weights.from_jax_params(p, device="cpu")
    got = plegacy.attention_block(pp, torch.from_numpy(x), h,
                                  pp.get("rel_pos"))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mean", [False, True])
def test_forward_matches_jax(rng, mean):
    p = randomised_legacy(jax.random.PRNGKey(4), 100, 64, 2, 4)
    mel = rng.standard_normal((2, 50, 100)).astype(np.float32)
    want = np.asarray(jlegacy.forward(p, jnp.asarray(mel), heads=4,
                                      mean=mean))
    got = plegacy.forward(weights.from_jax_params(p, device="cpu"),
                          torch.from_numpy(mel), heads=4, mean=mean)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_get_conditioning_v1_matches_jax(rng):
    tree = v1_gpt_tree(jax.random.PRNGKey(5), GPT_V1)
    mel = rng.standard_normal((1, 70, 100)).astype(np.float32)
    lens = np.array([70])
    want = np.asarray(jgpt.get_conditioning(
        jgpt.stack_blocks(tree), jgpt.GPTConfig(**GPT_V1), jnp.asarray(mel),
        jnp.asarray(lens)))
    got = pgpt.get_conditioning(weights.from_jax_params(tree, device="cpu"),
                                pconfig.GPTConfig(**GPT_V1),
                                torch.from_numpy(mel), torch.from_numpy(lens))
    assert got.shape == want.shape == (1, 32, GPT_V1["model_dim"])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_v1_infer_fast_matches_jax(tmp_path):
    k1, k2 = jax.random.split(jax.random.PRNGKey(9))
    tree = {"gpt": v1_gpt_tree(k1, GPT_V1),
            "bigvgan": jax.tree.map(np.asarray, jbigvgan.init(
                k2, jbigvgan.BigVGANConfig(**BV_SMALL)))}
    jeng = JaxTTS(config=jconfig.EngineConfig(
        gpt=jgpt.GPTConfig(**GPT_V1), bigvgan=jbigvgan.BigVGANConfig(
            **BV_SMALL)), params=tree, verbose_init=False)
    peng = PortTTS(config=pconfig.EngineConfig(
        gpt=pconfig.GPTConfig(**GPT_V1), bigvgan=pconfig.BigVGANConfig(
            **BV_SMALL)), params=tree, device="cpu", verbose_init=False)
    rng = np.random.default_rng(1)
    prompt = tmp_path / "prompt.wav"
    from index_tts_dubbing_tpu_torch.utils.audio import write_wav
    write_wav(prompt, (rng.standard_normal(24000) * 0.1).astype(np.float32),
              24000)
    kw = dict(GREEDY, max_mel_tokens=16, **SPLIT)
    jsr, jwav = jeng.infer_fast(str(prompt), TEXT, **dict(kw))
    psr, pwav = peng.infer_fast(str(prompt), TEXT, **dict(kw))
    assert jsr == psr == 24000
    np.testing.assert_array_equal(peng.last_fused_res.codes.numpy(),
                                  np.asarray(jeng.last_fused_res.codes))
    assert_i16_close(pwav, jwav)
