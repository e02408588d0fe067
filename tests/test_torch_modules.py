"""Each module of the port's infer_fast slice held against its JAX
counterpart at the small config of tests/test_engine.py, in float32, on the
same inputs (made with numpy from a seed) and the same weights (the JAX init
functions' output carried across by weights.from_jax_params)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.engine import decode as jdecode
from index_tts_dubbing_tpu.engine import tts as jtts
from index_tts_dubbing_tpu.engine import vocoder as jvocoder
from index_tts_dubbing_tpu.models import bigvgan as jbigvgan
from index_tts_dubbing_tpu.models import ecapa as jecapa
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu.ops import mel as jmel
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.engine import decode as pdecode
from index_tts_dubbing_tpu_torch.engine import tts as ptts
from index_tts_dubbing_tpu_torch.engine import vocoder as pvocoder
from index_tts_dubbing_tpu_torch.models import ecapa as pecapa
from index_tts_dubbing_tpu_torch.models import gpt as pgpt
from index_tts_dubbing_tpu_torch.ops import mel as pmel

# tests/test_engine.py:17-23
GPT_SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=60,
                 max_text_tokens=50, number_text_tokens=120,
                 cond_output_size=32, cond_linear_units=64,
                 cond_attention_heads=4, cond_num_blocks=2)
BV_SMALL = dict(gpt_dim=64, upsample_initial_channel=128)


@pytest.fixture(scope="module")
def models():
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    jg_cfg = jgpt.GPTConfig(**GPT_SMALL)
    jb_cfg = jbigvgan.BigVGANConfig(**BV_SMALL)
    jp = {"gpt": jgpt.init(k1, jg_cfg), "bigvgan": jbigvgan.init(k2, jb_cfg)}
    return {"jcfg": jg_cfg, "jbcfg": jb_cfg, "jp": jp,
            "cfg": pconfig.GPTConfig(**GPT_SMALL),
            "bcfg": pconfig.BigVGANConfig(**BV_SMALL),
            "p": weights.from_jax_params(jp, device="cpu")}


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_mel_matches_jax(rng):
    wav = (rng.standard_normal(24000) * 0.1).astype(np.float32)
    ref = np.asarray(jmel.MelSpectrogram()(wav))
    got = pmel.MelSpectrogram(device="cpu")(wav).numpy()
    assert got.shape == ref.shape == (1, 100, 94)
    # log-mel of float32 FFT magnitudes: pocketfft vs XLA's FFT differ by
    # ~1e-6 relative on the magnitudes, which log turns into ~1e-6 absolute;
    # 1e-4 leaves margin for the low-energy bins near the 1e-7 clip
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_conditioning_matches_jax(models, rng):
    mel = rng.standard_normal((2, 120, 100)).astype(np.float32)
    lens = np.array([120, 97])
    ref = np.asarray(jgpt.get_conditioning(models["jp"]["gpt"], models["jcfg"],
                                           mel, lens))
    got = pgpt.get_conditioning(models["p"]["gpt"], models["cfg"], t(mel),
                                t(lens)).numpy()
    assert got.shape == ref.shape == (2, 32, 64)
    # float32 through 2 conformer blocks and 2 perceiver layers; outputs are
    # RMS-normalised to O(1), summation-order differences stay < 1e-5
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_prefill_and_decode_steps_match_jax(models, rng):
    cfg, jcfg = models["cfg"], models["jcfg"]
    rows = [rng.integers(2, 120, size=11).astype(np.int32),
            rng.integers(2, 120, size=5).astype(np.int32)]
    pre = jdecode.prepare_prefix_host(jcfg, rows, pad_to=16)
    pre_p = pdecode.prepare_prefix_host(cfg, rows, pad_to=16)
    for k in pre:
        np.testing.assert_array_equal(pre[k], pre_p[k])
    conds = rng.standard_normal((2, 32, 64)).astype(np.float32)
    jemb, jkeep = jdecode.build_prefix_emb(
        models["jp"]["gpt"], jcfg, conds, *(pre[k] for k in
                                            ("ids", "pos", "seg", "cond_idx")))
    emb, keep = pdecode.build_prefix_emb(
        models["p"]["gpt"], cfg, t(conds),
        *(t(pre[k]).long() for k in ("ids", "pos", "seg", "cond_idx")))
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=1e-6)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))

    b, s0 = keep.shape
    steps = 5
    jcache = jgpt.init_cache(jcfg, b, s0 + steps)
    jh, jcache = jgpt.trunk_prefill(models["jp"]["gpt"], jcfg, jemb, jkeep,
                                    jcache)
    cache = pgpt.init_cache(cfg, b, s0 + steps, torch.float32, "cpu")
    h = pgpt.trunk_prefill(models["p"]["gpt"], cfg, emb, keep, cache)
    # float32 trunk of 2 layers, layer-normed output: < 1e-5 observed
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=1e-4)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), atol=1e-4)

    toks = rng.integers(0, 8194, size=(steps, b))
    jkeep_all = np.concatenate([np.asarray(jkeep), np.ones((b, steps), bool)], 1)
    keep_all = torch.cat([keep, torch.zeros((b, steps), dtype=torch.bool)], 1)
    for j in range(1, steps + 1):
        slot = s0 + j - 1
        x_np = (np.asarray(models["jp"]["gpt"]["mel_emb"]["w"])[toks[j - 1]]
                + np.asarray(models["jp"]["gpt"]["mel_pos"]["w"])[j + 1])
        kk = jkeep_all & (np.arange(s0 + steps)[None, :] <= slot)
        jh, jcache = jgpt.trunk_decode_step(models["jp"]["gpt"], jcfg, x_np,
                                            jcache, slot, kk)
        keep_all[:, slot] = True
        h = pgpt.trunk_decode_step(models["p"]["gpt"], cfg, t(x_np), cache,
                                   slot, keep_all)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4)
        jl = jgpt.mel_logits_from_hidden(models["jp"]["gpt"], jh)
        pl_ = pgpt.mel_logits_from_hidden(models["p"]["gpt"], h)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=1e-4)


@pytest.mark.parametrize("sc_kw", [
    {},                                              # the slice's defaults
    {"temperature": 0.7, "top_k": 0, "top_p": 0.9},
    {"typical_sampling": True, "top_p": 1.0},
    {"do_sample": False},
])
def test_process_logits_matches_jax(rng, sc_kw):
    logits = (rng.standard_normal((3, 500)) * 3).astype(np.float32)
    seen = rng.random((3, 500)) < 0.1
    jsc = jdecode.SamplingConfig(**sc_kw)
    psc = pdecode.SamplingConfig(**sc_kw)
    # the port's one setting beyond JAX's, IndexTTS-2's warper order, off:
    # the order the JAX decode runs
    assert dataclasses.asdict(psc) == {**dataclasses.asdict(jsc),
                                       "warp_each_step": False}
    ref = np.asarray(jdecode._process_logits(jnp.asarray(logits),
                                             jnp.asarray(seen), jsc))
    got = pdecode._process_logits(t(logits), t(seen), psc).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    # the kept logits are the inputs after one exact scale (penalty and
    # temperature are single float32 divisions or products)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=0)


def test_remove_long_silence_device_matches_jax(rng):
    codes = rng.integers(40, 60, size=(4, 80))
    codes[0, 50:] = 8193                           # stop mid-row
    codes[1, 10:55] = 52                           # a long silence run
    codes[2, 5:45:2] = 52                          # many short silences
    ref_codes, ref_lens = jtts.remove_long_silence_device(jnp.asarray(codes))
    got_codes, got_lens = ptts.remove_long_silence_device(t(codes))
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    host_codes, host_lens = ptts.remove_long_silence(codes)
    np.testing.assert_array_equal(host_lens, got_lens.numpy())


def test_ecapa_matches_jax(models, rng):
    mel = rng.standard_normal((1, 80, 100)).astype(np.float32)
    ref = np.asarray(jecapa.forward(models["jp"]["bigvgan"]["speaker_encoder"],
                                    mel))
    got = pecapa.forward(models["p"]["bigvgan"]["speaker_encoder"],
                         t(mel)).numpy()
    assert got.shape == ref.shape == (1, 1, 512)
    # float32 convs over 1536 channels, batch-normed: < 1e-5 observed
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_stream_device_matches_jax_exact(models, rng):
    """The port's windowed C-major vocoder (plain K1/K2 on the CPU, exact
    edge patches) against the JAX package's exact windowed path on a
    300-frame stream stitched from three rows."""
    mel_ref = rng.standard_normal((1, 50, 100)).astype(np.float32)
    lat = (rng.standard_normal((3, 128, 64)) * 0.3).astype(np.float32)
    lens = np.array([100, 120, 80])
    order = np.array([2, 0, 1])
    jv = jvocoder.WindowedVocoder(models["jp"]["bigvgan"], models["jbcfg"],
                                  layout="ref")
    ref = jv.stream_device(jnp.asarray(lat), lens, order=order,
                           mel_ref=mel_ref)
    pv = pvocoder.WindowedVocoder(models["p"]["bigvgan"], models["bcfg"])
    spk = pv.speaker_embedding(t(mel_ref))
    got = pv.stream_device(t(lat), lens, order=order, spk=spk)
    assert got.shape == ref.shape == (300 * 1024,)
    # float32 through ~40 chained convs; the kernels' replicate-pad edges
    # are patched by the exact route, so the whole stream is compared.
    # The JAX test of its own fused path vs exact uses 3e-4; ours < 1e-5.
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
