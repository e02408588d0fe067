"""Kernel K2's plan (ops/resblock_cmajor.py), held on the CPU against the
plain version it must reproduce:

- the tile plan: cutting the input the way the kernel's grid does (the
  wrapper's tile picker, each tile's span clamped to [0, T-1], a ragged
  last tile) and stitching the tiles gives the whole call;
- the float32 operand split: ``tf32_split`` mirrors ``cvt.rna.tf32.f32``,
  and three TF32 passes hold the chip's float32 tolerance on the conv chain
  where one pass does not.

Inputs at chip_smoke.py's scale (weights N(0,1)·0.1, x·0.5, α and β
N(0,1)·0.3) from a numpy seed; all math float32 unless stated.
"""
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch.ops import resblock_cmajor as rb

DILS = (1, 3, 5)
F32_TOL = 1e-4          # chip_smoke.py's TOL[float32], relative to max|plain|


class _Cfg:
    activation = "snakebeta"
    snake_logscale = True


def _packed(rng, c, k):
    def conv():
        return {"w": torch.from_numpy(
                    (rng.standard_normal((k, c, c)) * 0.1).astype(np.float32)),
                "b": torch.from_numpy(
                    (rng.standard_normal(c) * 0.1).astype(np.float32))}

    def act():
        return {name: torch.from_numpy(
                    (rng.standard_normal(c) * 0.3).astype(np.float32))
                for name in ("alpha", "beta")}
    tree = {"convs1": [conv() for _ in range(3)],
            "convs2": [conv() for _ in range(3)],
            "acts": [act() for _ in range(6)]}
    return rb.pack_resblock(tree, _Cfg(), torch.float32)


@pytest.mark.parametrize("c", rb.KERNEL_WIDTHS)
@pytest.mark.parametrize("k", [3, 7, 11])
def test_tiles_stitch_to_the_whole_call(rng, c, k):
    t_probe = 1 << 20
    tt = rb.pick_tile(c, k, DILS, t_probe)
    t = 2 * tt + 37                       # ragged: not a multiple of tt
    assert rb.pick_tile(c, k, DILS, t) == tt and t % tt
    span = rb.chain_shrink(k, DILS)
    w = _packed(rng, c, k)
    x = torch.from_numpy((rng.standard_normal((1, c, t)) * 0.5)
                         .astype(np.float32))
    whole = rb.resblock_cmajor_plain(x, *w, k, DILS)
    tiles = []
    for t0 in range(0, t, tt):
        idx = torch.arange(t0 - span, t0 + tt + span).clamp(0, t - 1)
        y = rb.resblock_cmajor_plain(x[..., idx], *w, k, DILS)
        tiles.append(y[..., span: span + min(tt, t - t0)])
    stitched = torch.cat(tiles, dim=-1)
    assert stitched.shape == whole.shape
    # the same float32 ops on overlapping windows; only the conv
    # algorithm's summation order may differ with the width
    lim = 1e-5 * whole.abs().max().item()
    assert (stitched - whole).abs().max().item() <= lim


@pytest.mark.parametrize("c", rb.KERNEL_WIDTHS)
@pytest.mark.parametrize("k", [3, 7, 11])
def test_tile_plan_fits_and_keeps_the_halo_small(c, k):
    tt = rb.pick_tile(c, k, DILS, 1 << 20)
    w = tt + 2 * rb.chain_shrink(k, DILS)
    assert tt % 32 == 0 and rb.smem_bytes(c, w) <= rb._SMEM_LIMIT
    assert rb.smem_bytes(c, w + 32) > rb._SMEM_LIMIT or tt == rb._MAX_TILE
    # the C = 96 stage (57% of K2's conv FLOPs) keeps tt >= 256
    assert tt >= 256 and w / tt <= 1.75


def test_tf32_split_rounds_as_cvt_rna(rng):
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096),
        [1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),          # ties: away from 0
         1.0 + 2.0 ** -11 + 2.0 ** -20, 1.0 + 2.0 ** -12]]).astype(np.float32))
    hi, lo = rb.tf32_split(x)
    for part in (hi, lo):                  # at most 10 explicit mantissa bits
        assert not (part.view(torch.int32) & 0x1FFF).any()
    tail = hi[-4:].tolist()
    assert tail == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                    1.0 + 2.0 ** -10, 1.0]
    # hi is x to nearest at 11 significant bits
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    # hi + lo restores x to 2^-21 relative
    assert ((x - (hi + lo)).abs() <= 2.0 ** -21 * x.abs()).all()


def _tf32_conv(passes):
    """_conv_shrink with the kernel's TF32 products: operands split by
    tf32_split, the product terms summed in float64."""
    def conv(v, w, b, k, d, in_dtype):
        c = v.shape[1]
        wt = w.float().reshape(k, rb._cpad(c), -1)[:, :c, :].permute(2, 1, 0)
        xh, xl = rb.tf32_split(v.to(in_dtype).float())
        wh, wl = rb.tf32_split(wt)
        terms = [(xh, wh)] + ([(xh, wl), (xl, wh)] if passes == 3 else [])
        acc = sum(F.conv1d(a.double(), f.double(), dilation=d)
                  for a, f in terms)
        return acc.float() + b
    return conv


def test_three_tf32_passes_hold_the_float32_tolerance(rng):
    c, k, t = 96, 11, 512
    w = _packed(rng, c, k)
    x = torch.from_numpy((rng.standard_normal((1, c, t)) * 0.5)
                         .astype(np.float32))
    ref = rb.resblock_cmajor_plain(x, *w, k, DILS)
    lim = F32_TOL * ref.abs().max().item()
    err = {}
    for passes in (1, 3):
        with mock.patch.object(rb, "_conv_shrink", _tf32_conv(passes)):
            got = rb.resblock_cmajor_plain(x, *w, k, DILS)
        err[passes] = (got - ref).abs().max().item()
    assert err[3] <= lim < err[1], (err, lim)
