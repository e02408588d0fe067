"""The four ancestry-routed trunk steps added for the beam histories and the
unbucketed latent pass, held against the JAX package's on the CPU, in
float32, with the same weights (the JAX init carried across by
weights.from_jax_params) and the same numpy inputs, at the small config of
tests/test_engine.py:

- ``trunk_decode_step_split_anc_bias``, ``_split_anc_sw`` (at slots that
  take each of its three widths), ``_split_ancg`` and
  ``trunk_decode_step_anc_full`` on a random ancestry map: hidden within
  1e-5, the written cache slot within 1e-5 and every other slot as it
  was;
- ``forward_latent`` within 1e-5, and equal to ``forward_latent_bucketed``
  at the inputs' own widths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.models import gpt as pgpt

# tests/test_engine.py:17-23
GPT_SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=60,
                 max_text_tokens=50, number_text_tokens=120,
                 cond_output_size=32, cond_linear_units=64,
                 cond_attention_heads=4, cond_num_blocks=2)
NB = 3
B, S0 = 2, 11
# float32, 2 layers, layer-normed output
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = jgpt.GPTConfig(**GPT_SMALL)
    jp = jax.tree.map(np.array, jgpt.init(jax.random.PRNGKey(3), jcfg))
    return dict(jcfg=jcfg, jp=jp, cfg=pconfig.GPTConfig(**GPT_SMALL),
                p=weights.from_jax_params(jp, device="cpu"))


def _inputs(rng, cfg, g):
    """Prefix K/V (L, B, H, S0, D), gen K/V in the ancestry layout
    (L, B, H, nb, G, D), x (B·nb, C), a prefix pad mask with padding in
    row 1 and a random ancestry map (B, nb, G)."""
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    shape_p = (cfg.layers, B, cfg.heads, S0, cfg.head_dim)
    shape_g = (cfg.layers, B, cfg.heads, NB, g, cfg.head_dim)
    keep = np.ones((B, S0), bool)
    keep[1, :5] = False
    amap = rng.integers(0, NB, size=(B, NB, g)).astype(np.int32)
    return (f(*shape_p), f(*shape_p), f(*shape_g), f(*shape_g),
            f(B * NB, cfg.model_dim), keep, amap)


def _check(h, jh, got, want, before, slot):
    """Hidden within TOL; the caches written at ``slot`` (axis 4) within TOL
    of JAX's (layer 1's K/V carry layer 0's rounding) and equal to their
    inputs everywhere else."""
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL, rtol=0)
    for a, b, c in zip(got, want, before):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a[:, :, :, :, slot], b[:, :, :, :, slot],
                                   atol=TOL, rtol=0)
        other = np.arange(a.shape[4]) != slot
        np.testing.assert_array_equal(a[:, :, :, :, other], c[:, :, :, :, other])
        np.testing.assert_array_equal(b[:, :, :, :, other], c[:, :, :, :, other])


@pytest.mark.parametrize("name,g,slot", [
    ("trunk_decode_step_split_anc_bias", 16, 6),
    ("trunk_decode_step_split_anc_sw", 40, 3),      # width 10
    ("trunk_decode_step_split_anc_sw", 40, 15),     # width 20
    ("trunk_decode_step_split_anc_sw", 40, 30),     # width 40
    ("trunk_decode_step_split_ancg", 16, 6),
    ("trunk_decode_step_split_ancg", 16, 0),
])
def test_split_anc_steps_match_jax(setup, rng, name, g, slot):
    cfg = setup["cfg"]
    kp, vp, kg, vg, x, keep, amap = _inputs(rng, cfg, g)
    # the JAX steps run inside a traced loop, where the slot is an array
    jh, jc = getattr(jgpt, name)(setup["jp"], setup["jcfg"], x,
                                 jgpt.SplitCache(kp, vp, kg, vg),
                                 jnp.int32(slot), keep, NB, amap)
    t = torch.from_numpy
    cache = pgpt.SplitCache(t(kp), t(vp), t(kg.copy()), t(vg.copy()))
    h = getattr(pgpt, name)(setup["p"], cfg, t(x), cache, slot, t(keep), NB,
                            t(amap).long())
    _check(h, jh, (cache.kg, cache.vg), (jc.kg, jc.vg), (kg, vg), slot)


def test_anc_sw_equals_anc_at_every_width(setup, rng):
    """The bounded widths only drop masked slots: "ancsw" equals "anc"
    within TOL at the first and last slot of each of its widths."""
    cfg = setup["cfg"]
    kp, vp, kg, vg, x, keep, amap = _inputs(rng, cfg, 40)
    t = torch.from_numpy
    for slot in (0, 9, 10, 19, 20, 39):
        out = []
        for fn in (pgpt.trunk_decode_step_split_anc,
                   pgpt.trunk_decode_step_split_anc_sw):
            cache = pgpt.SplitCache(t(kp), t(vp), t(kg.copy()), t(vg.copy()))
            out.append(fn(setup["p"], cfg, t(x), cache, slot, t(keep), NB,
                          t(amap).long()))
        np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("j", [1, 7])
def test_anc_full_step_matches_jax(setup, rng, j):
    """The merged-buffer step at absolute slot S0 + j - 1, the prefix
    replicated over the beams, on a random ancestry map over all slots."""
    cfg = setup["cfg"]
    g = 12
    s_total = S0 + g
    kp, vp, _, _, x, keep, _ = _inputs(rng, cfg, g)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    shape = (cfg.layers, B, cfg.heads, NB, s_total, cfg.head_dim)
    kf, vf = f(*shape), f(*shape)
    kf[:, :, :, :, :S0] = kp[:, :, :, None]
    vf[:, :, :, :, :S0] = vp[:, :, :, None]
    keep_full = np.concatenate([keep, np.ones((B, g), bool)], axis=1)
    amap = rng.integers(0, NB, size=(B, NB, s_total)).astype(np.int32)
    slot = S0 + j - 1
    jh, jk, jv = jgpt.trunk_decode_step_anc_full(
        setup["jp"], setup["jcfg"], x, kf, vf, slot, keep_full, NB, amap)
    t = torch.from_numpy
    pk, pv = t(kf.copy()), t(vf.copy())
    h = pgpt.trunk_decode_step_anc_full(setup["p"], cfg, t(x), pk, pv, slot,
                                        t(keep_full), NB, t(amap).long())
    _check(h, jh, (pk, pv), (jk, jv), (kf, vf), slot)


def _latent_inputs(rng, cfg):
    """Two rows of text and codes with shorter real lengths than their
    padded widths."""
    conds = rng.standard_normal((2, 32, cfg.model_dim)).astype(np.float32)
    text = rng.integers(2, 120, size=(2, 9)).astype(np.int32)
    codes = rng.integers(0, 8192, size=(2, 13)).astype(np.int32)
    return (conds, text, np.array([9, 6], np.int32), codes,
            np.array([13, 8], np.int32))


def test_forward_latent_matches_jax(setup, rng):
    args = _latent_inputs(rng, setup["cfg"])
    ref = np.asarray(jgpt.forward_latent(setup["jp"], setup["jcfg"], *args))
    t = [torch.from_numpy(a) if a.dtype == np.float32
         else torch.from_numpy(a).long() for a in args]
    got = pgpt.forward_latent(setup["p"], setup["cfg"], *t)
    assert got.shape == ref.shape == (2, 13, 64)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    # the bucketed pass right-aligns and masks the short text: at the
    # inputs' own widths the full row (text_lens == width) is the same
    # computation, so the two agree on row 0 up to its code length
    buck = pgpt.forward_latent_bucketed(setup["p"], setup["cfg"], *t)
    np.testing.assert_allclose(buck[0].numpy(), got[0].numpy(), atol=TOL,
                               rtol=0)
