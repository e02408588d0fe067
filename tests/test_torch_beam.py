"""The port's beam decode held against the JAX package's on the CPU, in
float32, with the same weights (the JAX init's output carried across by
weights.from_jax_params) and the same numpy inputs, at the small config of
tests/test_engine.py:

- the two split-cache decode steps (physical order and ancestry-routed);
- the beam warper chain;
- beam search token-exact for both history strategies ("anc", "cof"), with
  a dead ``live`` row and length_penalty 0 and 1;
- beam sampling token-exact, with the port's Gumbel noise replaced by the
  noise the JAX decode draws from the same key.

The stop code's logit carries a bias in the shared parameters, so rows
finish before the cap and the finished-hypothesis pool decides the output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.engine import decode as jdecode
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.engine import decode as pdecode
from index_tts_dubbing_tpu_torch.models import gpt as pgpt
from index_tts_dubbing_tpu_torch.ops import permute

# tests/test_engine.py:17-23
GPT_SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=60,
                 max_text_tokens=50, number_text_tokens=120,
                 cond_output_size=32, cond_linear_units=64,
                 cond_attention_heads=4, cond_num_blocks=2)
NB = 3
STEPS = 40
# added to the stop code's logit: with it, beam search and beam sampling
# both end some rows well before STEPS and others at it
STOP_BIAS = 1.0
LIVE = np.array([True, True, True, False])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process; one torch
    thread runs these small decodes ~20x faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jgpt.GPTConfig(**GPT_SMALL)
    jp = jax.tree.map(np.array, jgpt.init(jax.random.PRNGKey(3), jcfg))
    jp["mel_head"]["b"][jcfg.stop_mel_token] += STOP_BIAS
    rng = np.random.default_rng(0)
    texts = [rng.integers(2, 120, size=n).astype(np.int32) for n in (9, 5, 7, 3)]
    conds = rng.standard_normal((4, 32, 64)).astype(np.float32)
    pre = jdecode.prepare_prefix_host(jcfg, texts)
    names = ("ids", "pos", "seg", "cond_idx")
    jemb, jkeep = jdecode.build_prefix_emb(jp, jcfg, conds,
                                           *(pre[k] for k in names))
    cfg = pconfig.GPTConfig(**GPT_SMALL)
    p = weights.from_jax_params(jp, device="cpu")
    emb, keep = pdecode.build_prefix_emb(
        p, cfg, torch.from_numpy(conds),
        *(torch.from_numpy(pre[k]).long() for k in names))
    return dict(jcfg=jcfg, jp=jp, jemb=jemb, jkeep=jkeep, cfg=cfg, p=p,
                emb=emb, keep=keep)


def _jax_beam(s, stochastic, lp, key=0):
    sc = jdecode.SamplingConfig(do_sample=stochastic, max_mel_tokens=STEPS)
    return jdecode._beam_decode(s["jp"], s["jcfg"], sc, s["jemb"], s["jkeep"],
                                jax.random.PRNGKey(key), NB, lp,
                                stochastic=stochastic, live=jnp.asarray(LIVE))


def _port_beam(s, stochastic, lp, reorder):
    sc = pdecode.SamplingConfig(do_sample=stochastic, max_mel_tokens=STEPS)
    return pdecode._beam_decode(s["p"], s["cfg"], sc, s["emb"], s["keep"],
                                None, NB, lp, stochastic=stochastic,
                                reorder=reorder, live=torch.from_numpy(LIVE))


def _assert_same(jres, pres):
    np.testing.assert_array_equal(pres.codes.numpy(), np.asarray(jres.codes))
    np.testing.assert_array_equal(pres.lengths.numpy(),
                                  np.asarray(jres.lengths))


def _split_inputs(rng, cfg, b, s0, g):
    shape_p = (cfg.layers, b, cfg.heads, s0, cfg.head_dim)
    shape_g = (cfg.layers, b * NB, cfg.heads, g, cfg.head_dim)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    keep = np.ones((b, s0), bool)
    keep[1, :5] = False
    return (f(*shape_p), f(*shape_p), f(*shape_g), f(*shape_g),
            f(b * NB, cfg.model_dim), keep)


def test_decode_step_split_matches_jax(setup, rng):
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    b, s0, g, slot = 2, 11, 16, 6
    kp, vp, kg, vg, x, keep = _split_inputs(rng, cfg, b, s0, g)
    jh, jc = jgpt.trunk_decode_step_split(
        setup["jp"], jcfg, x, jgpt.SplitCache(kp, vp, kg, vg), slot, keep, NB)
    t = torch.from_numpy
    cache = pgpt.SplitCache(t(kp), t(vp), t(kg.copy()), t(vg.copy()))
    h = pgpt.trunk_decode_step_split(setup["p"], cfg, t(x), cache, slot,
                                     t(keep), NB)
    # float32, 2 layers, layer-normed output: < 1e-6 observed
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(cache.kg.numpy(), np.asarray(jc.kg), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(cache.vg.numpy(), np.asarray(jc.vg), atol=1e-5,
                               rtol=0)


def test_decode_step_split_anc_matches_jax(setup, rng):
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    b, s0, g, slot = 2, 11, 16, 6
    kp, vp, kg, vg, x, keep = _split_inputs(rng, cfg, b, s0, g)
    # the ancestry layout (L, B, H, nb, G, D)
    to_anc = lambda a: np.ascontiguousarray(a.reshape(
        cfg.layers, b, NB, cfg.heads, g, cfg.head_dim).transpose(0, 1, 3, 2, 4, 5))
    kg, vg = to_anc(kg), to_anc(vg)
    amap = rng.integers(0, NB, size=(b, NB, g)).astype(np.int32)
    jh, jc = jgpt.trunk_decode_step_split_anc(
        setup["jp"], jcfg, x, jgpt.SplitCache(kp, vp, kg, vg), slot, keep, NB,
        amap)
    t = torch.from_numpy
    cache = pgpt.SplitCache(t(kp), t(vp), t(kg.copy()), t(vg.copy()))
    h = pgpt.trunk_decode_step_split_anc(setup["p"], cfg, t(x), cache, slot,
                                         t(keep), NB, t(amap).long())
    # float32, 2 layers, layer-normed output: < 1e-6 observed
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(cache.kg.numpy(), np.asarray(jc.kg), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(cache.vg.numpy(), np.asarray(jc.vg), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.7, top_k=0),
                                dict(top_k=1, top_p=0.5)])
def test_warp_scores_matches_jax(rng, kw):
    scores = (rng.standard_normal((6, 8194)) * 3.0 - 9.0).astype(np.float32)
    ref = np.asarray(jdecode._warp_scores(
        jnp.asarray(scores), jdecode.SamplingConfig(**kw)))
    got = pdecode._warp_scores(torch.from_numpy(scores),
                               pdecode.SamplingConfig(**kw)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    assert (~np.isneginf(got)).sum(1).min() >= 2          # min_tokens_to_keep
    # temperature division is the only arithmetic on the kept values
    np.testing.assert_allclose(got[~np.isneginf(got)], ref[~np.isneginf(ref)],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("lp", [0.0, 1.0])
def test_beam_search_token_exact(setup, lp):
    """Beam search over both history strategies equals JAX (and so each
    other), token for token; the dead row yields nothing and at least one
    live row finishes before the cap."""
    jres = _jax_beam(setup, False, lp)
    anc = _port_beam(setup, False, lp, "anc")
    cof = _port_beam(setup, False, lp, "cof")
    _assert_same(jres, anc)
    _assert_same(jres, cof)
    lens = anc.lengths.numpy()
    assert lens[~LIVE].tolist() == [0]
    assert (lens[LIVE] < STEPS).any(), lens


@pytest.mark.parametrize("reorder", ["anc", "cof"])
def test_beam_sample_token_exact_with_the_jax_noise(setup, monkeypatch,
                                                    reorder):
    """Beam sampling equals JAX when the port draws the JAX noise: the
    Gumbel sample of ``sub0`` from ``split(rng)`` at step 0, then of each
    ``sub`` from ``key, sub = split(key)``."""
    key = 7          # a key under which rows finish before the cap
    jres = _jax_beam(setup, True, 0.0, key)
    shape = (len(LIVE), NB * setup["jcfg"].number_mel_codes)
    k, sub = jax.random.split(jax.random.PRNGKey(key))
    noise = [jax.random.gumbel(sub, shape, jnp.float32)]
    for _ in range(STEPS - 1):
        k, sub = jax.random.split(k)
        noise.append(jax.random.gumbel(sub, shape, jnp.float32))
    draws = iter(noise)

    def jax_gumbel(shp, generator, device):
        assert tuple(shp) == shape
        return torch.from_numpy(np.array(next(draws)))

    monkeypatch.setattr(pdecode, "_gumbel", jax_gumbel)
    pres = _port_beam(setup, True, 0.0, reorder)
    _assert_same(jres, pres)
    lens = pres.lengths.numpy()
    assert (lens[LIVE] < STEPS).any(), lens


def test_cof_calls_copy_on_fork_once_per_step(setup, monkeypatch):
    """The cof decode calls copy_on_fork once per selection step, the first
    (bound -1) included, through the wrapper, which on the CPU takes the
    plain version and counts no launch; an unported strategy names its
    ROADMAP item."""
    bounds = []

    def spy(kg, vg, cp, bound, gb=64):
        bounds.append(bound)
        return real(kg, vg, cp, bound, gb)

    real = permute.copy_on_fork
    real.launches = 0
    monkeypatch.setattr(permute, "copy_on_fork", spy)
    res = _port_beam(setup, False, 0.0, "cof")
    assert bounds == list(range(-1, res.steps - 1))
    assert real.launches == 0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_beam(setup, False, 0.0, "split")
