"""The unbucketed latent pass held against the JAX package's on the CPU,
in float32, with the same weights (the JAX init carried across by
weights.from_jax_params) and the same numpy inputs, at the small config of
tests/test_engine.py: ``forward_latent`` within 1e-5, and equal to
``forward_latent_bucketed`` at the inputs' own widths.
"""
import jax
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
# float32, 2 layers, layer-normed output
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = jgpt.GPTConfig(**GPT_SMALL)
    jp = jax.tree.map(np.array, jgpt.init(jax.random.PRNGKey(3), jcfg))
    return dict(jcfg=jcfg, jp=jp, cfg=pconfig.GPTConfig(**GPT_SMALL),
                p=weights.from_jax_params(jp, device="cpu"))


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
