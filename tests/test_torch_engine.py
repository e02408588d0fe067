"""The rest of the engine against the JAX engine, part 1: the host helpers
(pad_tokens_cat, bucket_sentences), the bucketed latent pass, the
one-program fused flavour (synthesize_fused, and infer_fast at decode caps
<= 256) beside the fused+stream flavour. Part 2 (the staged route, infer,
infer_batch and the surfaces) is tests/test_torch_engine_staged.py.

Both engines run in float32 on the same weights and prompt, at the small
config of tests/test_torch_e2e.py with max_text_tokens raised to 130, so a
sentence can pass the largest text bucket (120) and stay inside the model.
On the CPU the port runs the plain versions of kernels K1 and K2; the JAX
engine vocodes by its exact routes (no Pallas kernel on the CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.engine import tts as jtts
from index_tts_dubbing_tpu.engine.tts import IndexTTS as JaxTTS
from index_tts_dubbing_tpu.models import bigvgan as jbigvgan
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu.utils import audio as jaudio
from index_tts_dubbing_tpu.utils import config as jconfig
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.engine import tts as ptts
from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS as PortTTS

GPT_SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=260,
                 max_text_tokens=130, number_text_tokens=120,
                 cond_output_size=32, cond_linear_units=64,
                 cond_attention_heads=4, cond_num_blocks=2)
BV_SMALL = dict(gpt_dim=64, upsample_initial_channel=128)
# three sentences at max_text_tokens_per_sentence=20: 3 rows, padded to the
# batch bucket 4 with one dead row
TEXT = "Hello there friend. The quick brown fox jumps. Over the lazy dog!"
SPLIT = dict(max_text_tokens_per_sentence=20)
GREEDY = dict(do_sample=False, num_beams=1)
BEAM = dict(do_sample=False)                   # beam search, num_beams=3
# float32 wavs in [-1, 1]: both engines vocode by float32 convs in another
# summation order (< 2e-5 observed, tests/test_torch_modules.py); the int16
# cast of clip(wav·32767) then lands at most 2 LSB apart
WAV_TOL = 1e-4
I16_TOL = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process; one torch
    thread runs these small decodes many times faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_engines(tmp_dir):
    """The JAX engine, the port on its weights, and a random 1 s prompt."""
    jcfg = jconfig.EngineConfig(gpt=jgpt.GPTConfig(**GPT_SMALL),
                                bigvgan=jbigvgan.BigVGANConfig(**BV_SMALL))
    jeng = JaxTTS(config=jcfg, verbose_init=False, seed=0)
    pcfg = pconfig.EngineConfig(gpt=pconfig.GPTConfig(**GPT_SMALL),
                                bigvgan=pconfig.BigVGANConfig(**BV_SMALL))
    peng = PortTTS(config=pcfg, device="cpu", verbose_init=False,
                   params=weights.from_jax_params(jeng.params, device="cpu"))
    rng = np.random.default_rng(1)
    prompt = tmp_dir / "prompt.wav"
    jaudio.write_wav(prompt, (rng.standard_normal(24000) * 0.1
                              ).astype(np.float32), 24000)
    return jeng, peng, str(prompt)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return make_engines(tmp_path_factory.mktemp("engine"))


def assert_i16_close(pwav, jwav):
    assert pwav.dtype == jwav.dtype == np.int16
    assert pwav.shape == jwav.shape
    if pwav.size:
        diff = np.abs(pwav.astype(np.int32) - jwav.astype(np.int32))
        assert diff.max() <= I16_TOL, diff.max()


# ---------------------------------------------------------------- host


@pytest.mark.parametrize("version", [1.0, 1.5])
def test_pad_tokens_cat_matches_jax(version):
    rows = [np.arange(2, 12, dtype=np.int32), np.arange(2, 30, dtype=np.int32),
            np.arange(2, 8, dtype=np.int32), np.zeros(0, np.int32)]
    got = ptts.pad_tokens_cat(rows, 1, 0, version)
    want = jtts.pad_tokens_cat(rows, 1, 0, version)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lens", [
    [5, 0, 7],                                   # <= bucket_max_size
    [5, 6, 7, 30, 31, 2, 3, 40, 0, 12, 9, 0],    # > it, with empty ones
    [3] * 33,                                    # one length, many buckets
])
def test_bucket_sentences_matches_jax(lens):
    sents = [["a"] * n for n in lens]
    for size in (4, 8):
        assert (ptts.bucket_sentences(sents, size)
                == jtts.bucket_sentences(sents, size))


# ---------------------------------------------------------------- latents


def test_latents_batch_device_matches_jax(engines):
    """Mixed (text, code) lengths over two (text, code) buckets: lens and inv
    equal, the latents within 1e-5 on every valid frame; _latents_batch and
    _latents cut the same frames."""
    jeng, peng, prompt = engines
    rng = np.random.default_rng(4)
    rows = []
    for lt, lc in ((9, 40), (30, 70), (12, 64), (20, 130), (5, 3)):
        ids = rng.integers(2, 100, size=lt).astype(np.int32)
        codes = rng.integers(0, 8192, size=lc + 5).astype(np.int32)
        rows.append((ids, codes, lc))
    jc = jeng._conditioning(jeng._cond_mel(prompt))
    pc = peng._conditioning(peng._cond_mel(prompt))
    jlat, jlens, jinv = jeng._latents_batch_device(jc, rows)
    plat, plens, pinv = peng._latents_batch_device(pc, rows)
    np.testing.assert_array_equal(plens, jlens)
    np.testing.assert_array_equal(pinv, jinv)
    assert tuple(plat.shape) == jlat.shape == (8, 192, 64)
    jlat, plat = np.asarray(jlat), plat.numpy()
    for i, (_, _, lc) in enumerate(rows):
        np.testing.assert_allclose(plat[pinv[i], :lc], jlat[jinv[i], :lc],
                                   atol=1e-5)
    for got, want in zip(peng._latents_batch(pc, rows),
                         jeng._latents_batch(jc, rows)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)
    ids, codes, lc = rows[1]
    np.testing.assert_allclose(peng._latents(pc, ids, codes, lc),
                               jeng._latents(jc, ids, codes, lc), atol=1e-5)


# ---------------------------------------------------------------- fused


@pytest.mark.parametrize("decode,cap", [
    ("greedy", 60),   # 180 frames: windows of the plan, one of them junk
    ("greedy", 16),   # 48 frames < window + 2·halo: the short fallback
    ("beam", 60),
    ("beam", 16),
])
def test_synthesize_fused_matches_jax(engines, decode, cap):
    """synthesize_fused on the padded batch (3 rows + 1 dead) with the
    default window count: codes, lens and stream_frames equal JAX's, the
    float32 wav within WAV_TOL, FusedResult.wav_i16 within I16_TOL of JAX's
    and exactly clip(wav·32767) truncated."""
    jeng, peng, prompt = engines
    kw = dict(GREEDY if decode == "greedy" else BEAM, max_mel_tokens=cap)
    out = []
    for eng in (jeng, peng):
        sc = eng._sampling_config(dict(kw))
        cond_mel = eng._cond_mel(prompt)
        conds = eng._conditioning(cond_mel)
        if eng is jeng:
            spk = eng.vocoder.speaker_embedding(
                jnp.asarray(np.asarray(cond_mel).transpose(0, 2, 1)))
        else:
            spk = eng._speaker(cond_mel)
        rows = peng.sentence_rows(TEXT, 20)
        rows += [np.array([2], np.int32)]
        live = np.array([True, True, True, False])
        out.append(eng.synthesize_fused(
            conds, rows, sc, spk,
            live=live if eng is jeng else torch.from_numpy(live)))
    (jwav, jres), (pwav, pres) = out
    np.testing.assert_array_equal(pres.codes.numpy(), np.asarray(jres.codes))
    np.testing.assert_array_equal(pres.lens.numpy(), np.asarray(jres.lens))
    t = int(pres.stream_frames)
    assert t == int(jres.stream_frames) == 3 * cap
    assert pres.lens[3] == 0
    up = peng.vocoder.upsample
    assert pwav.dtype == np.float32 and pwav.shape == jwav.shape == (t * up,)
    np.testing.assert_allclose(pwav, jwav, atol=WAV_TOL)
    nw = -(-4 * cap // peng.vocoder.window)
    assert pres.wav.shape == (nw * peng.vocoder.window * up,)
    i16 = pres.wav_i16[: t * up].numpy()
    want = np.clip(pres.wav[: t * up].numpy() * 32767.0, -32767.0,
                   32767.0).astype(np.int16)
    np.testing.assert_array_equal(i16, want)
    if t >= peng.vocoder.window + 2 * peng.vocoder.halo:
        assert nw * peng.vocoder.window > t          # a junk window
        np.testing.assert_allclose(pres.wav[: t * up].numpy(), pwav)
        assert_i16_close(i16, np.asarray(jres.wav_i16)[: t * up])
    # emit="i16" returns the same stream as int16
    pi16, _ = peng.synthesize_fused(
        peng._conditioning(peng._cond_mel(prompt)), rows,
        peng._sampling_config(dict(kw)), peng._speaker(peng._cond_mel(prompt)),
        live=torch.from_numpy(live), emit="i16")
    np.testing.assert_array_equal(
        pi16, np.clip(pwav * 32767.0, -32767.0, 32767.0).astype(np.int16))


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_infer_fast_fused_flavour_matches_jax(engines, decode):
    """infer_fast at max_mel_tokens=16: both engines take the one-program
    flavour; codes token-exact, the int16 wav within I16_TOL."""
    jeng, peng, prompt = engines
    kw = dict(GREEDY if decode == "greedy" else BEAM, max_mel_tokens=16,
              **SPLIT)
    jsr, jwav = jeng.infer_fast(prompt, TEXT, **dict(kw))
    psr, pwav = peng.infer_fast(prompt, TEXT, **dict(kw))
    assert jeng.last_path == peng.last_path == "fused"
    assert jeng.last_fused_flavor == peng.last_fused_flavor == "fused"
    np.testing.assert_array_equal(peng.last_fused_res.codes.numpy(),
                                  np.asarray(jeng.last_fused_res.codes))
    assert jsr == psr == 24000
    assert pwav.shape == (3 * 16 * peng.vocoder.upsample, 1)
    assert_i16_close(pwav, jwav)


def test_fused_flavours_agree(engines, monkeypatch):
    """At max_mel_tokens=260 the port takes the fused+stream flavour (held
    against JAX for greedy and beam search in tests/test_torch_e2e.py);
    moved under the one-program flavour's threshold, the same request gives
    the same codes and, through the static window plan (8 windows, 7 of them
    over the 780 frames), the same wav within I16_TOL (JAX holds its two
    flavours equal the same way, tests/test_engine.py:311)."""
    _, peng, prompt = engines
    kw = dict(GREEDY, max_mel_tokens=260, **SPLIT)
    _, stream = peng.infer_fast(prompt, TEXT, **dict(kw))
    assert peng.last_fused_flavor == "fused+stream"
    codes = peng.last_fused_res.codes
    monkeypatch.setattr(PortTTS, "FUSED_FULL_VOCODE_MAX_STEPS", 260)
    _, one = peng.infer_fast(prompt, TEXT, **dict(kw))
    assert peng.last_fused_flavor == "fused"
    assert peng.last_fused_res.wav.numel() == 8 * 112 * 1024
    np.testing.assert_array_equal(peng.last_fused_res.codes, codes)
    assert one.shape == stream.shape == (780 * 1024, 1)
    assert_i16_close(one, stream)
