"""The windowed C-major vocoder's three switches against the JAX package:
``use_pallas`` (kernel K1 for every activation outside a fused resblock),
``fuse_resblocks`` (kernel K2 for each resblock of the C ≤ 128 stages) and
``edge_exact`` (the exact route over the stream's two ends).

The port's ``WindowedVocoder`` and JAX's ``WindowedVocoder(layout="cmajor")``
run with the same switches on the same weights and inputs in float32, JAX's
Pallas kernels in interpret mode. On the CPU the port's wrappers take K1's
and K2's plain versions, which carry the kernels' edge semantics (and, in
the exact-edge mode the exact work asks for, are the exact route's own
ops), so the whole wav is compared, ends included. The routes each setting takes are
counted at full width on meta tensors, and the engine serves a switched
vocoder on every route of ``infer_fast``.
"""
import itertools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from index_tts_dubbing_tpu.engine import vocoder as jvocoder
from index_tts_dubbing_tpu.models import bigvgan as jbigvgan
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.engine import vocoder as pvocoder
from index_tts_dubbing_tpu_torch.ops import snake_cmajor
from tests.test_torch_engine import (GREEDY, SPLIT, TEXT, assert_i16_close,
                                     make_engines)
from tests.test_torch_engine_staged import record_decodes
from tests.test_torch_kernels import _interpret

SETTINGS = list(itertools.product((False, True), repeat=3))
WINDOW = HALO = 16
# tests/test_engine.py's BigVGAN (gpt_dim 64) cut to two upsample stages of
# 136 and 68 channels: one stage above 128 (K1's when both kernels run) and
# one at most 128 (K2's), so the three kernel settings take three routes,
# and JAX's interpret-mode kernels run in seconds (its six 64 … 2-channel
# stages at 1024× upsampling take minutes in K2's interpreter)
BV_CUT = dict(gpt_dim=64, upsample_initial_channel=272, upsample_rates=(4, 4),
              upsample_kernel_sizes=(8, 8))
# per window batch of the cut config: 18 activations a stage, act_post
K1_CUT = {(True, False): 37, (True, True): 19}
K2_CUT = {(False, True): 3, (True, True): 3}
# float32 through the same convs in another summation order (< 1e-7 seen)
WAV_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cut():
    """The cut BigVGAN on both sides, a 57-frame stream of three rows in an
    order, its 48-frame head (a short stream: at most window + 2·halo) and
    one speaker embedding."""
    jcfg = jbigvgan.BigVGANConfig(**BV_CUT)
    jp = jbigvgan.init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(5)
    lat = (rng.standard_normal((3, 30, 64)) * 0.3).astype(np.float32)
    lens, order = np.array([20, 25, 12]), np.array([1, 2, 0])
    stream = np.concatenate([lat[r, : lens[r]] for r in order])
    mel = rng.standard_normal((1, 50, 100)).astype(np.float32)
    spk = np.asarray(jvocoder.speaker_embedding(jp, mel))
    return {"jcfg": jcfg, "jp": jp, "cfg": pconfig.BigVGANConfig(**BV_CUT),
            "p": weights.from_jax_params(jp, device="cpu"), "lat": lat,
            "lens": lens, "order": order, "stream": stream,
            "short": stream[: WINDOW + 2 * HALO], "spk": spk}


class _Count:
    """Counts calls of the K1 and K2 wrappers and of the window function by
    route, around the real functions."""

    def __init__(self, monkeypatch):
        self.k1 = self.k2 = 0
        self.batches = []          # (windows, exact) per _vocode call
        k1, k2 = snake_cmajor.snake_cmajor, pvocoder.resblock_cmajor
        vocode = pvocoder.WindowedVocoder._vocode

        def c1(*a, **kw):
            self.k1 += 1
            return k1(*a, **kw)

        def c2(*a, **kw):
            self.k2 += 1
            return k2(*a, **kw)

        def cv(voc, windows, spk, exact):
            self.batches.append((windows.shape[0], exact))
            return vocode(voc, windows, spk, exact)

        monkeypatch.setattr(snake_cmajor, "snake_cmajor", c1)
        monkeypatch.setattr(pvocoder, "resblock_cmajor", c2)
        monkeypatch.setattr(pvocoder.WindowedVocoder, "_vocode", cv)


@pytest.mark.parametrize("use_pallas,fuse_resblocks,edge_exact", SETTINGS)
def test_switches_match_jax(cut, monkeypatch, use_pallas, fuse_resblocks,
                            edge_exact):
    """``__call__``, ``stream_device`` (three rows in an order) and a short
    stream within WAV_TOL of JAX's over the whole wav; the patch route runs
    only when ``edge_exact`` is set and a kernel runs."""
    sw = dict(window=WINDOW, halo=HALO, max_batch=1, use_pallas=use_pallas,
              fuse_resblocks=fuse_resblocks, edge_exact=edge_exact)
    spk = cut["spk"]
    with mock.patch.object(pl, "pallas_call", _interpret):
        jv = jvocoder.WindowedVocoder(cut["jp"], cut["jcfg"], layout="cmajor",
                                      **sw)
        want = [jv(cut["stream"], spk=spk),
                jv.stream_device(jnp.asarray(cut["lat"]), cut["lens"],
                                 order=cut["order"], spk=spk),
                jv(cut["short"], spk=spk)]
    count = _Count(monkeypatch)
    pv = pvocoder.WindowedVocoder(cut["p"], cut["cfg"], **sw)
    pspk = torch.from_numpy(spk)
    got = [pv(cut["stream"], spk=pspk),
           pv.stream_device(torch.from_numpy(cut["lat"]), cut["lens"],
                            order=cut["order"], spk=pspk),
           pv(cut["short"], spk=pspk)]
    for g, w, n in zip(got, want, (57, 57, 48)):
        assert g.shape == w.shape == (n * 16,)
        np.testing.assert_allclose(g, w, atol=WAV_TOL, rtol=0)

    kernels = use_pallas or fuse_resblocks
    patched = edge_exact and kernels
    assert pv.edge_exact == edge_exact and pv._edge_approx() == kernels
    # two streams of four one-window batches, each with two patches when
    # patched, then the short stream as one batch, exact with edge_exact;
    # the exact batches run on the kernels too, in their exact-edge mode
    per_stream = [(1, False)] * 4 + [(2, True)] * patched
    assert count.batches == per_stream * 2 + [(1, edge_exact)]
    kernel_batches = len(count.batches)
    assert count.k1 == K1_CUT.get((use_pallas, fuse_resblocks), 0) * \
        kernel_batches
    assert count.k2 == K2_CUT.get((use_pallas, fuse_resblocks), 0) * \
        kernel_batches
    # K2's weights are packed only for a route that runs K2
    assert bool(pv._packed) == fuse_resblocks


@pytest.mark.parametrize("use_pallas,fuse_resblocks",
                         list(itertools.product((False, True), repeat=2)))
def test_routes_per_window_batch(monkeypatch, use_pallas, fuse_resblocks):
    """At full width (stages of 768 … 24 channels; on meta tensors, so
    nothing is computed) one window batch of 4 launches K1 109 times with
    ``use_pallas`` alone, K2 9 times with ``fuse_resblocks`` alone, and
    K1 55 and K2 9 with both; the defaults are both on, and ``edge_exact``
    follows them."""
    cfg = pconfig.BigVGANConfig(gpt_dim=64)
    p = weights.init_bigvgan(weights.Init(None, "meta"), cfg)
    n = {"k1": 0, "k2": 0}

    def k1(x, *a, **kw):
        n["k1"] += 1
        return torch.empty_like(x)

    def k2(x, *a, **kw):
        n["k2"] += 1
        return torch.empty_like(x)

    monkeypatch.setattr(snake_cmajor, "snake_cmajor", k1)
    monkeypatch.setattr(pvocoder, "resblock_cmajor", k2)
    voc = pvocoder.WindowedVocoder(p, cfg, use_pallas=use_pallas,
                                   fuse_resblocks=fuse_resblocks)
    assert voc.edge_exact == (use_pallas or fuse_resblocks)
    wav = voc._vocode(torch.empty(4, 144, 64, device="meta"),
                      torch.empty(1, 1, 512, device="meta"), exact=False)
    assert wav.shape == (4, 144 * 1024)
    want = {(False, False): (0, 0), (True, False): (109, 0),
            (False, True): (0, 9), (True, True): (55, 9)}
    assert (n["k1"], n["k2"]) == want[(use_pallas, fuse_resblocks)]
    default = pvocoder.WindowedVocoder(p, cfg)
    assert (default.use_pallas, default.fuse_resblocks,
            default.edge_exact) == (True, True, True)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return make_engines(tmp_path_factory.mktemp("switches"))


@pytest.mark.parametrize("text,kw,path", [
    (TEXT, dict(GREEDY, max_mel_tokens=20, **SPLIT), "fused"),
    ("x" * 125, dict(GREEDY, max_mel_tokens=60,
                     max_text_tokens_per_sentence=130), "staged")])
def test_engine_with_switched_vocoder_matches_jax(engines, monkeypatch, text,
                                                  kw, path):
    """``tts.vocoder`` replaced on both engines by a K1-only vocoder
    (use_pallas, not fuse_resblocks, edge_exact) at window 16: infer_fast on
    the one-program flavour (three sentences, 60 frames) and on the staged
    route (one 125-token sentence, 60 frames), greedy: the same codes, the
    int16 wav within 2 LSB, and the port's K1 run on every activation of
    each vocoder batch, the exact ones included (109 at the small config's
    six stages), K2 never."""
    jeng, peng, prompt = engines
    sw = dict(window=WINDOW, halo=HALO, use_pallas=True, fuse_resblocks=False)
    jeng.vocoder = jvocoder.WindowedVocoder(
        jeng.params["bigvgan"], jeng.bigvgan_cfg, layout="cmajor", **sw)
    peng.vocoder = pvocoder.WindowedVocoder(peng.params["bigvgan"],
                                            peng.bigvgan_cfg, **sw)
    jcodes = record_decodes(monkeypatch, jeng)
    with mock.patch.object(pl, "pallas_call", _interpret):
        _, jwav = jeng.infer_fast(prompt, text, **dict(kw))
    pcodes = record_decodes(monkeypatch, peng)
    count = _Count(monkeypatch)
    _, pwav = peng.infer_fast(prompt, text, **dict(kw))
    assert jeng.last_path == peng.last_path == path
    if path == "fused":
        assert peng.last_fused_flavor == "fused"
        jcodes = [np.asarray(jeng.last_fused_res.codes)]
        pcodes = [peng.last_fused_res.codes.numpy()]
    assert len(pcodes) == len(jcodes) == 1
    np.testing.assert_array_equal(pcodes[0], jcodes[0])
    assert pwav.shape == (60 * 1024, 1)
    assert_i16_close(pwav, jwav)
    # every batch, the exact ones too (K1's exact-edge mode)
    assert [n for n, exact in count.batches if not exact] and count.k2 == 0
    assert count.k1 == 109 * len(count.batches)
    assert (2, True) in count.batches           # the edge patches
