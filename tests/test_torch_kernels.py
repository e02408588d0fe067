"""The port's kernels K1 (ops/snake_cmajor.py) and K2 (ops/resblock_cmajor.py)
held against the JAX package's Pallas kernels run in interpret mode on the
CPU, over the WHOLE tensor (edges included: the plain versions implement
the kernels' replicate-pad edge semantics). On the CPU the wrappers take
the plain versions and launch nothing. Inputs come from a numpy seed; all
math is float32."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from index_tts_dubbing_tpu.ops import pallas_resblock, pallas_snake
from index_tts_dubbing_tpu_torch.ops import resblock_cmajor as rb_port
from index_tts_dubbing_tpu_torch.ops import snake_cmajor as snake_port

_ORIG_CALL = pl.pallas_call


def _interpret(*args, **kw):
    kw["interpret"] = True
    return _ORIG_CALL(*args, **kw)


class _Cfg:
    activation = "snakebeta"
    snake_logscale = True


def _mk_resblock(rng, c, k, npair=3):
    def conv():
        return {"w": (rng.standard_normal((k, c, c)) * 0.1).astype(np.float32),
                "b": (rng.standard_normal(c) * 0.1).astype(np.float32)}
    return {"convs1": [conv() for _ in range(npair)],
            "convs2": [conv() for _ in range(npair)],
            "acts": [{"alpha": (rng.standard_normal(c) * 0.3).astype(np.float32),
                      "beta": (rng.standard_normal(c) * 0.3).astype(np.float32)}
                     for _ in range(2 * npair)]}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


@pytest.mark.parametrize("c", [24, 192])
@pytest.mark.parametrize("t", [64, 200])
@pytest.mark.parametrize("logscale", [True, False])
def test_snake_plain_matches_pallas(rng, c, t, logscale):
    x = rng.standard_normal((2, c, t)).astype(np.float32)
    alpha = (rng.standard_normal(c) * 0.3).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.3).astype(np.float32)
    with mock.patch.object(pallas_snake.pl, "pallas_call", _interpret):
        ref = np.asarray(pallas_snake.fused_anti_alias_snake_cmajor(
            x, alpha, beta, logscale))
    got = snake_port.snake_cmajor_plain(torch.from_numpy(x),
                                        torch.from_numpy(alpha),
                                        torch.from_numpy(beta), logscale)
    assert got.shape == ref.shape and got.dtype == torch.float32
    # same float32 arithmetic in the same order; the bound covers FMA
    # contraction and sin ulp differences between XLA:CPU and torch: 2e-5
    # absolute for O(1) outputs, plus a few float32 ulps (rtol 1e-6) where
    # 1/β is large (β ≈ 0 without the log-scale gives outputs ~1e2)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-6)


@pytest.mark.parametrize("k", [3, 11])
@pytest.mark.parametrize("t", [256, 300])
def test_resblock_plain_matches_pallas(rng, k, t):
    c, dils = 24, (1, 3, 5)
    rb = _mk_resblock(rng, c, k)
    x = (rng.standard_normal((2, c, t)) * 0.5).astype(np.float32)
    packed = pallas_resblock.pack_resblock(rb, _Cfg(), jnp.float32)
    with mock.patch.object(pallas_resblock.pl, "pallas_call", _interpret):
        ref = np.asarray(pallas_resblock.fused_resblock_cmajor(
            jnp.asarray(x), *packed, k, dils))
    w = rb_port.pack_resblock(_to_torch(rb), _Cfg(), torch.float32)
    for a, b in zip(w, packed):      # the port packs the same layout
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    got = rb_port.resblock_cmajor_plain(torch.from_numpy(x), *w, k, dils)
    assert got.shape == ref.shape
    # six float32 convs of k·C-term sums chained through six activations
    # with ~N(0, 0.1) weights; summation order differs (XLA dot vs torch
    # conv): the same bound as tests/test_pallas_resblock.py's interior
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-4, rtol=1e-4)


def test_chain_shrink_and_tile():
    assert [rb_port.chain_shrink(k, (1, 3, 5)) for k in (3, 7, 11)] == [48, 72, 96]
    # K2's sizing at C = 96: one float32 (96, lda ≥ 288 + 2·96 - 12)
    # buffer and the 3-stage weight ring fit; the residual is in scratch
    assert rb_port.pick_tile(96, 11, (1, 3, 5), 36864) == 288
    assert rb_port.pick_tile(24, 3, (1, 3, 5), 100) == 128


def test_wrappers_on_cpu_take_plain_and_launch_nothing(rng):
    c, t, k, dils = 24, 256, 3, (1, 3, 5)
    x = torch.from_numpy(rng.standard_normal((1, c, t)).astype(np.float32))
    alpha = torch.from_numpy((rng.standard_normal(c) * 0.3).astype(np.float32))
    before = (snake_port.snake_cmajor.launches,
              rb_port.resblock_cmajor.launches)
    y = snake_port.snake_cmajor(x, alpha, alpha, True)
    torch.testing.assert_close(
        y, snake_port.snake_cmajor_plain(x, alpha, alpha, True), rtol=0, atol=0)
    w = rb_port.pack_resblock(_to_torch(_mk_resblock(rng, c, k)), _Cfg(),
                              torch.float32)
    z = rb_port.resblock_cmajor(x, *w, k, dils)
    torch.testing.assert_close(
        z, rb_port.resblock_cmajor_plain(x, *w, k, dils), rtol=0, atol=0)
    assert (snake_port.snake_cmajor.launches,
            rb_port.resblock_cmajor.launches) == before == (0, 0)


def test_kernel_build_is_hashed_and_needs_no_build_here():
    """The library name carries a hash of the sources and flags; resolving
    it builds nothing (the CPU path never compiles)."""
    from index_tts_dubbing_tpu_torch.ops import cuda_lib
    p = cuda_lib.library_path()
    assert p.parent == cuda_lib.BUILD_DIR and p.name.startswith("libkernels_")
    assert {s.name for s in cuda_lib._sources()} >= {
        "snake_cmajor.cu", "resblock_cmajor.cu"}
    assert cuda_lib._lib is None
