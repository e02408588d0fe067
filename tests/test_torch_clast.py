"""The port's channels-last vocoder route held against the JAX package's on
the CPU, in float32, with the same numpy inputs and weights:

- kernel B3's plain version (ops/snake_clast.py) against the Pallas
  ``fused_anti_alias_snake`` run in interpret mode, over the whole tensor,
  edges included;
- the exact channels-last ``anti_aliased_activation``;
- ``models/bigvgan.forward``, ``engine/vocoder._vocode_window`` and
  ``WindowedVocoder(layout="ref")`` (``__call__`` and ``stream_device``,
  a multi-window and a short stream), each with ``use_pallas`` False and
  True. With True the JAX side runs Pallas in interpret mode and the port
  runs B3's plain version (it is on the CPU);
- ``IndexTTS(use_pallas=True)``: ``infer_fast`` is unchanged by the flag,
  because the engine's vocoder is the C-major one.

The BigVGAN is the small config of tests/test_vocoder_window.py with its
snake α and β drawn at random, so every per-channel parameter matters. The
window and stream cases cut it to its first two stages (×16): each distinct
shape costs the JAX side an XLA compile of every stage, and the driver code
under test is the same at any depth.
"""
import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from index_tts_dubbing_tpu.engine import vocoder as jvocoder
from index_tts_dubbing_tpu.models import bigvgan as jbigvgan
from index_tts_dubbing_tpu.ops import alias_free as jaf
from index_tts_dubbing_tpu.ops import pallas_snake
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.engine import vocoder as pvocoder
from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS as PortTTS
from index_tts_dubbing_tpu_torch.models import bigvgan as pbigvgan
from index_tts_dubbing_tpu_torch.ops import alias_free as paf
from index_tts_dubbing_tpu_torch.ops import snake_clast
from index_tts_dubbing_tpu_torch.utils import audio

# tests/test_vocoder_window.py:10-11
BV_SMALL = dict(upsample_initial_channel=128, gpt_dim=16,
                speaker_embedding_dim=512)
# the window and stream cases: the first two stages
BV_TWO_STAGES = dict(BV_SMALL, upsample_rates=(4, 4),
                     upsample_kernel_sizes=(8, 8))
WINDOW, HALO = 16, 16
# the JAX package's own windowed-vs-exact bound (tests/test_vocoder_window.py)
ATOL = 2e-5

_ORIG_CALL = pl.pallas_call


def _interpret(*args, **kw):
    kw["interpret"] = True
    return _ORIG_CALL(*args, **kw)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _pallas_interpret():
    with mock.patch.object(pallas_snake.pl, "pallas_call", _interpret):
        yield


def t(x):
    return torch.from_numpy(np.array(x))


def _random_snakes(tree, rng):
    """The tree with every snake α and β replaced by N(0, 0.3²) draws."""
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(np.shape(v)).astype(np.float32) * 0.3
                    if k in ("alpha", "beta") else _random_snakes(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_random_snakes(v, rng) for v in tree]
    return np.asarray(tree)


def _models(kw, rng):
    """JAX and port configs ({False, True} → (jcfg, pcfg)) and the shared
    weights (JAX numpy tree, port tensors)."""
    jcfg = jbigvgan.BigVGANConfig(**kw)
    jp = _random_snakes(jbigvgan.init(jax.random.PRNGKey(7), jcfg), rng)
    cfgs = {flag: (dataclasses.replace(jcfg, use_pallas=flag),
                   pconfig.BigVGANConfig(**kw, use_pallas=flag))
            for flag in (False, True)}
    return cfgs, jp, weights.from_jax_params(jp, device="cpu")


@pytest.fixture(scope="module")
def voc():
    """The full small config ("full") and its first two stages ("two"),
    a speaker mel and a latent bank of three rows."""
    rng = np.random.default_rng(5)
    return {"full": _models(BV_SMALL, rng),
            "two": _models(BV_TWO_STAGES, rng),
            "mel": rng.standard_normal((1, 50, 100)).astype(np.float32),
            "lat": (rng.standard_normal((3, 32, 16)) * 0.3).astype(np.float32)}


@pytest.mark.parametrize("c", [24, 192])
@pytest.mark.parametrize("t_len", [57, 64, 200])      # 57: 8 ∤ T
@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("with_beta", [True, False])
def test_snake_clast_plain_matches_pallas(rng, c, t_len, logscale, with_beta):
    x = rng.standard_normal((2, t_len, c)).astype(np.float32)
    alpha = (rng.standard_normal(c) * 0.3).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.3).astype(np.float32) if with_beta else None
    ref = np.asarray(pallas_snake.fused_anti_alias_snake(x, alpha, beta,
                                                         logscale))
    got = snake_clast.snake_clast(t(x), t(alpha),
                                  None if beta is None else t(beta), logscale)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert snake_clast.snake_clast.launches == 0     # the CPU takes the plain
    # same float32 arithmetic in the same order; XLA:CPU and torch may
    # contract a multiply-add or round sin an ulp apart: 1e-5 absolute for
    # O(1) outputs, plus a few float32 ulps (rtol 1e-6) where 1/β is large
    # (β ≈ 0 without the log-scale gives outputs ~1e2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("with_beta", [True, False])
def test_anti_aliased_activation_matches_jax(rng, logscale, with_beta):
    c = 24
    x = rng.standard_normal((2, 57, c)).astype(np.float32)
    alpha = (rng.standard_normal(c) * 0.3).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.3).astype(np.float32) if with_beta else None
    ref = np.asarray(jaf.anti_aliased_activation(x, alpha, beta, logscale))
    got = paf.anti_aliased_activation(t(x), t(alpha),
                                      None if beta is None else t(beta),
                                      logscale)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bigvgan_forward_matches_jax(voc, use_pallas):
    cfgs, jp, p = voc["full"]
    jcfg, pcfg = cfgs[use_pallas]
    lat = voc["lat"][:2, :24]
    # jitted: one XLA compile per flag costs less than eager dispatch
    ref = np.asarray(jax.jit(jbigvgan.forward, static_argnums=1)(
        jp, jcfg, lat, voc["mel"]))
    got = pbigvgan.forward(p, pcfg, t(lat), t(voc["mel"]))
    assert got.shape == ref.shape == (2, 24 * 1024)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_vocode_window_matches_jax(voc, use_pallas):
    """Four full windows with one speaker embedding broadcast over them (the
    window batch of the stream tests below)."""
    cfgs, jp, p = voc["two"]
    jcfg, pcfg = cfgs[use_pallas]
    full = WINDOW + 2 * HALO
    lat = np.concatenate([voc["lat"][:, :full // 2]] * 2, axis=1)
    lat = np.concatenate([lat, lat[:1, ::-1]])                 # (4, 48, 16)
    spk = np.asarray(jvocoder.speaker_embedding(jp, voc["mel"]))
    ref = np.asarray(jvocoder._vocode_window(jp, jcfg, lat, spk))
    got = pvocoder._vocode_window(p, pcfg, t(lat), t(spk))
    assert got.shape == ref.shape == (4, full * 16)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("stream", ["multi", "short"])
def test_windowed_ref_matches_jax(voc, use_pallas, stream):
    """``__call__`` on the host stream and ``stream_device`` on the latent
    bank, each against the JAX driver's same entry point. "multi": 59
    frames stitched from three rows (4 windows); "short": 20 frames of one
    row, one window at its own length."""
    cfgs, jp, p = voc["two"]
    jcfg, pcfg = cfgs[use_pallas]
    lat = voc["lat"]
    if stream == "multi":
        lens, order = np.array([20, 32, 7]), np.array([2, 0, 1])
    else:
        lens, order = np.array([0, 20, 0]), np.array([1])
    host = np.concatenate([lat[r, : lens[r]] for r in order])
    jv = jvocoder.WindowedVocoder(jp, jcfg, window=WINDOW, halo=HALO,
                                  layout="ref")
    pv = pvocoder.WindowedVocoder(p, pcfg, window=WINDOW, halo=HALO,
                                  layout="ref")
    ref = jv(host, voc["mel"])
    got = pv(host, voc["mel"])
    assert got.dtype == np.float32 and got.shape == ref.shape == (host.shape[0] * 16,)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    ref_dev = jv.stream_device(jax.numpy.asarray(lat), lens, order=order,
                               mel_ref=voc["mel"])
    got_dev = pv.stream_device(t(lat), lens, order=order, mel_ref=t(voc["mel"]))
    np.testing.assert_allclose(got_dev, ref_dev, atol=ATOL)
    # the two entry points see the same windows
    np.testing.assert_array_equal(got_dev, got)


def test_layout_default_and_check(voc):
    cfgs, _, p = voc["two"]
    pcfg = cfgs[True][1]
    assert pvocoder.WindowedVocoder(p, pcfg).layout == "cmajor"
    with pytest.raises(ValueError, match="layout"):
        pvocoder.WindowedVocoder(p, pcfg, layout="rows")


def test_index_tts_use_pallas_keeps_infer_fast(tmp_path):
    """``use_pallas=True`` sets the BigVGAN flag but leaves the engine's
    C-major vocoder, so greedy ``infer_fast`` gives the same wav."""
    gpt = pconfig.GPTConfig(model_dim=64, layers=2, heads=4,
                            max_mel_tokens=260, max_text_tokens=50,
                            number_text_tokens=120, cond_output_size=32,
                            cond_linear_units=64, cond_attention_heads=4,
                            cond_num_blocks=2)
    cfg = pconfig.EngineConfig(gpt=gpt, bigvgan=pconfig.BigVGANConfig(
        gpt_dim=64, upsample_initial_channel=128))
    base = PortTTS(config=cfg, device="cpu", verbose_init=False, seed=0)
    flagged = PortTTS(config=cfg, device="cpu", verbose_init=False,
                      use_pallas=True, params=base.params)
    assert flagged.bigvgan_cfg.use_pallas and not base.bigvgan_cfg.use_pallas
    assert flagged.vocoder.layout == base.vocoder.layout == "cmajor"
    prompt = tmp_path / "prompt.wav"
    audio.write_wav(prompt, (np.random.default_rng(1).standard_normal(24000)
                             * 0.1).astype(np.float32), 24000)
    kw = dict(num_beams=1, do_sample=False)
    sr, a = base.infer_fast(str(prompt), "Hello there friend.", **kw)
    sr2, b = flagged.infer_fast(str(prompt), "Hello there friend.", **kw)
    assert sr == sr2 == 24000 and a.size > 0
    np.testing.assert_array_equal(a, b)
