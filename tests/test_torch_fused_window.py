"""The grouped BigVGAN window form (``fuse_bigvgan_params`` and
``_vocode_window_fused``) held against the JAX package's on the CPU, in
float32, with the same numpy weights and inputs, at the small BigVGAN of
tests/test_vocoder_window.py with every snake α and β drawn at random
(tests/test_torch_clast.py's models):

- ``fuse_bigvgan_params`` array for array (exact: a re-layout with zero
  padding), at the whole small config;
- ``_vocode_window_fused`` within 1e-5 of JAX's and of the port's
  ``_vocode_window``, with ``use_pallas`` off and on. With it on,
  ``act_post`` takes kernel B3's plain version on the port (the tensors
  are on the CPU) and the Pallas kernel in interpret mode on JAX; the
  window function it is held against runs B3 at every activation, so the
  two are compared at least ``EDGE`` output samples from the window ends.
  The windows run the first two stages (×16), as test_torch_clast's do.
"""
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.engine import vocoder as jvocoder
from index_tts_dubbing_tpu_torch.engine import vocoder as pvocoder
from index_tts_dubbing_tpu_torch.ops import snake_clast
from tests.test_torch_clast import (BV_SMALL, BV_TWO_STAGES,  # noqa: F401
                                    _models, _one_torch_thread,
                                    _pallas_interpret, t)

TOL = 1e-5
# B3 recomputes its up-phases over the replicated input within ±3 frames of
# a tensor end where the exact route zero-pads; 12-tap FIRs widen that
# through each later stage: 8 latent frames × 16 samples stays clear of it
EDGE = 8 * 16


@pytest.fixture(scope="module")
def voc():
    rng = np.random.default_rng(5)
    return {"full": _models(BV_SMALL, rng), "two": _models(BV_TWO_STAGES, rng),
            "lat": (rng.standard_normal((2, 40, 16)) * 0.3).astype(np.float32),
            "spk": (rng.standard_normal((1, 1, 512)) * 0.3).astype(np.float32)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def test_fuse_bigvgan_params_matches_jax(voc):
    cfgs, jp, p = voc["full"]
    ref = _leaves(jvocoder.fuse_bigvgan_params(jp, cfgs[False][0]))
    got = _leaves(pvocoder.fuse_bigvgan_params(p, cfgs[False][1]))
    assert got.keys() == ref.keys()
    for name, arr in ref.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(arr),
                                      err_msg=name)
    st = got[".stages[0].w1"]
    # three pairs, width 5·(11 - 1) + 1, the three branches side by side
    assert tuple(st.shape) == (3, 51, 64, 3 * 64)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_vocode_window_fused_matches_jax_and_the_window(voc, use_pallas):
    cfgs, jp, p = voc["two"]
    jcfg, pcfg = cfgs[use_pallas]
    lat, spk = voc["lat"], voc["spk"]
    ref = np.asarray(jvocoder._vocode_window_fused(
        jvocoder.fuse_bigvgan_params(jp, jcfg), jcfg, lat, spk))
    snake_clast.snake_clast.launches = 0
    got = pvocoder._vocode_window_fused(
        pvocoder.fuse_bigvgan_params(p, pcfg), pcfg, t(lat), t(spk))
    assert snake_clast.snake_clast.launches == 0     # the CPU takes the plain
    assert got.shape == ref.shape == (2, 40 * 16)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    win = pvocoder._vocode_window(p, pcfg, t(lat), t(spk)).numpy()
    inner = slice(EDGE, -EDGE) if use_pallas else slice(None)
    np.testing.assert_allclose(got.numpy()[:, inner], win[:, inner], atol=TOL,
                               rtol=0)
