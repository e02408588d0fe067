"""Weight-only int8 (index_tts_dubbing_tpu_torch/utils/quant.py and the int8
branch of nn.linear) against the JAX package's utils/quant.py and nn.linear,
and ``IndexTTS(quantize="int8")`` against the JAX engine on the same
weights, on the CPU in float32 at the small config of tests/test_torch_e2e.py:

- the quantised weights equal JAX's bit for bit (the port's per-layer blocks
  against JAX's stacked trunk, unstacked), from float32 and from bfloat16
  weights (quantised after the dtype cast, as the JAX engine does);
- nn.linear on a quantised dict within 1e-6 of JAX's;
- greedy and beam-search infer_fast token-exact, the int16 wav within 2 LSB;
- int8 on the one-program fused route against the staged route, as JAX's
  tests/test_quant.py holds it;
- an unknown mode raises ValueError.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu import nn as jnn
from index_tts_dubbing_tpu.engine.tts import IndexTTS as JaxTTS
from index_tts_dubbing_tpu.models import bigvgan as jbigvgan
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu.utils import audio as jaudio
from index_tts_dubbing_tpu.utils import config as jconfig
from index_tts_dubbing_tpu.utils import quant as jquant
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import nn as pnn
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS as PortTTS
from index_tts_dubbing_tpu_torch.engine.tts import remove_long_silence
from index_tts_dubbing_tpu_torch.utils import quant as pquant

GPT_SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=260,
                 max_text_tokens=50, number_text_tokens=120,
                 cond_output_size=32, cond_linear_units=64,
                 cond_attention_heads=4, cond_num_blocks=2)
BV_SMALL = dict(gpt_dim=64, upsample_initial_channel=128)
TEXT = "Hello there friend. The quick brown fox jumps. Over the lazy dog!"
SPLIT = dict(max_text_tokens_per_sentence=20)
I16_TOL = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process; one torch
    thread runs these small decodes many times faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both engines with quantize="int8" on one float32 JAX tree, and a
    random 1 s prompt."""
    jcfg = jconfig.EngineConfig(gpt=jgpt.GPTConfig(**GPT_SMALL),
                                bigvgan=jbigvgan.BigVGANConfig(**BV_SMALL))
    tree = JaxTTS(config=jcfg, verbose_init=False, seed=0).params
    tree = jax.tree.map(np.asarray, tree)
    jeng = JaxTTS(config=jcfg, verbose_init=False, params=tree,
                  quantize="int8")
    pcfg = pconfig.EngineConfig(gpt=pconfig.GPTConfig(**GPT_SMALL),
                                bigvgan=pconfig.BigVGANConfig(**BV_SMALL))
    peng = PortTTS(config=pcfg, device="cpu", verbose_init=False,
                   params=tree, quantize="int8")
    rng = np.random.default_rng(1)
    prompt = tmp_path_factory.mktemp("quant") / "prompt.wav"
    jaudio.write_wav(prompt, (rng.standard_normal(24000) * 0.1
                              ).astype(np.float32), 24000)
    return jeng, peng, str(prompt)


def _gpt_tree():
    return jax.tree.map(np.asarray, jgpt.stack_blocks(jgpt.init(
        jax.random.PRNGKey(0), jgpt.GPTConfig(**GPT_SMALL))))


def _assert_quantised_equal(pq, jq, layer=None):
    pick = (lambda a: a) if layer is None else (lambda a: a[layer])
    assert pq.keys() == jq.keys()
    assert pq["w_q"].dtype == torch.int8 and pq["scale"].dtype == torch.float32
    np.testing.assert_array_equal(pq["w_q"].numpy(), pick(jq["w_q"]))
    np.testing.assert_array_equal(pq["scale"].numpy(), pick(jq["scale"]))
    np.testing.assert_array_equal(pq["b"].float().numpy(),
                                  np.asarray(pick(jq["b"]), np.float32))


def test_quantize_linear_int8_is_bit_exact():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((64, 128)) * 0.3).astype(np.float32)
    w[:, 5] = 0.0                        # an all-zero column: scale 1e-12
    b = rng.standard_normal(128).astype(np.float32)
    jq = jquant.quantize_linear_int8({"w": w, "b": b})
    pq = pquant.quantize_linear_int8({"w": torch.from_numpy(w),
                                      "b": torch.from_numpy(b)})
    _assert_quantised_equal(pq, jq)
    assert pquant.quantize_linear_int8(pq) is pq          # idempotent


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_gpt_int8_matches_jax_unstacked(dtype):
    tree = _gpt_tree()
    if dtype == "bfloat16":             # quantised after the cast, as JAX
        tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16)
                            if np.issubdtype(a.dtype, np.floating) else a,
                            tree)
    jq = jquant.quantize_gpt_int8(tree)
    ptree = weights.from_jax_params(
        tree, "cpu", torch.bfloat16 if dtype == "bfloat16" else None)
    pq = pquant.quantize_gpt_int8(ptree)
    assert len(pq["blocks"]) == GPT_SMALL["layers"]
    for i, blk in enumerate(pq["blocks"]):
        for group, names in (("attn", ("qkv", "proj")), ("mlp", ("fc", "proj"))):
            for name in names:
                _assert_quantised_equal(blk[group][name],
                                        jq["blocks"][group][name], layer=i)
        for name in ("ln1", "ln2"):                        # shared, as JAX
            assert blk[name] is ptree["blocks"][i][name]
    _assert_quantised_equal(pq["mel_head"], jq["mel_head"])
    for name in ("text_head", "mel_emb", "mel_pos", "cond_encoder"):
        assert pq[name] is ptree[name]


def test_linear_on_quantised_weights_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    want = np.asarray(jnn.linear(jquant.quantize_linear_int8({"w": w, "b": b}),
                                 jnp.asarray(x)))
    got = pnn.linear(pquant.quantize_linear_int8(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}),
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(
        want).max())


def _assert_i16_close(pwav, jwav):
    assert pwav.dtype == jwav.dtype == np.int16
    assert pwav.shape == jwav.shape and pwav.size
    diff = np.abs(pwav.astype(np.int32) - jwav.astype(np.int32))
    assert diff.max() <= I16_TOL, diff.max()


@pytest.mark.parametrize("decode", [dict(num_beams=1, do_sample=False),
                                    dict(do_sample=False)],
                         ids=["greedy", "beam_search"])
def test_int8_infer_fast_matches_jax(engines, decode):
    jeng, peng, prompt = engines
    assert peng.params["gpt"]["blocks"][0]["attn"]["qkv"]["w_q"].dtype \
        == torch.int8
    kw = dict(decode, max_mel_tokens=16, **SPLIT)
    jsr, jwav = jeng.infer_fast(prompt, TEXT, **dict(kw))
    psr, pwav = peng.infer_fast(prompt, TEXT, **dict(kw))
    assert jeng.last_path == peng.last_path == "fused"
    np.testing.assert_array_equal(peng.last_fused_res.codes.numpy(),
                                  np.asarray(jeng.last_fused_res.codes))
    assert jsr == psr
    _assert_i16_close(pwav, jwav)


def test_int8_fused_matches_staged(engines):
    """JAX tests/test_quant.py::test_int8_fused_matches_staged on the port:
    with one generator seed, the one-program flavour's codes equal the
    staged pipeline's and its wav is within 2e-3; the public infer_fast
    still takes the fused route under int8."""
    _, eng, prompt = engines
    rng = np.random.default_rng(3)
    cond_mel = rng.standard_normal((1, 100, 60)).astype(np.float32)
    eng.set_cond_mel(cond_mel, key="<int8-fused>")
    conds = eng._conditioning(eng._cond_mel("<int8-fused>"))
    spk = eng._speaker(eng._cond_mel("<int8-fused>"))
    rows = [rng.integers(2, 100, size=n).astype(np.int32) for n in (7, 5, 9)]
    sc = eng._sampling_config(dict(num_beams=1, do_sample=True,
                                   max_mel_tokens=20))

    eng._generator = torch.Generator("cpu").manual_seed(4)
    codes, _ = eng._decode_batch(conds, rows, sc)
    lat_rows = []
    for i in range(len(rows)):
        rc, rl = remove_long_silence(codes[i:i + 1], eng.stop_mel_token)
        lat_rows.append((rows[i], rc[0], int(rl[0])))
    lat_dev, lens, inv = eng._latents_batch_device(conds, lat_rows)
    wav_staged = eng.vocoder.stream_device(
        lat_dev, lens, order=inv[np.arange(len(rows))], spk=spk)

    eng._generator = torch.Generator("cpu").manual_seed(4)
    wav_fused, res = eng.synthesize_fused(conds, rows, sc, spk)
    np.testing.assert_array_equal(res.codes.numpy(), codes)
    np.testing.assert_allclose(wav_fused, wav_staged, atol=2e-3)

    sr, wav = eng.infer_fast(prompt, "ab ab. cd cd.", None, max_mel_tokens=12,
                             do_sample=False, num_beams=1)
    assert eng.last_path == "fused" and wav.shape[0] > 0


def test_unknown_quantize_mode_rejected():
    pcfg = pconfig.EngineConfig(gpt=pconfig.GPTConfig(**GPT_SMALL),
                                bigvgan=pconfig.BigVGANConfig(**BV_SMALL))
    with pytest.raises(ValueError, match="unknown quantize mode"):
        PortTTS(config=pcfg, device="cpu", verbose_init=False,
                quantize="fp4")
