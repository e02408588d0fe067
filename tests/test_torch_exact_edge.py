"""The exact-edge mode of kernels K1 and K2, and the vocoder's exact work on
it, on the CPU (torch and numpy; no JAX).

- The plain versions of both kernels in exact-edge mode are the exact
  route's own ops, bit for bit: K1's against ``downsample2(snake_beta(
  upsample2(x)))``, K2's against the vocoder's op-by-op resblock
  (``_resblock_cm``), at the C ≤ 128 stage widths of both vocoders
  (IndexTTS's ×1024 and F5's ×256 BigVGAN: 24, 48, 96), float32 and
  bfloat16, at lengths under the chain span, under twice it, and above.
- A float32 emulation of K2's block walk in exact-edge mode (tiles of tt
  columns, the pads each op sets outside [0, T) and the ×2 signal's clamp
  from csrc/exact_edge.cuh) equals the exact route, with tiles that reach
  one end, both ends, or neither.
- ``WindowedVocoder`` on the kernel route with ``exact=True`` gives the
  plain route's wav bit for bit: a short stream vocoded whole, the edge
  patches of a long stream, and ``stream_rows``' short lines.
- The exact work reaches K2 through ``engine.vocoder.resblock_cmajor`` with
  ``k`` at position 5 of its arguments after x and the mode as the keyword
  ``exact_edge`` (the benchmark's K2 recorder reads it), and the
  ``vocoder.exact`` span carries ``kernel_launches``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.config import BigVGANConfig, MelVocoderConfig
from index_tts_dubbing_tpu_torch.engine import vocoder as voc_mod
from index_tts_dubbing_tpu_torch.engine.vocoder import WindowedVocoder
from index_tts_dubbing_tpu_torch.ops import resblock_cmajor as k2
from index_tts_dubbing_tpu_torch.ops import snake_cmajor as k1
from index_tts_dubbing_tpu_torch.ops.alias_free import (
    DOWN_FILTER, UP_FILTER, downsample2, snake_beta, upsample2)
from index_tts_dubbing_tpu_torch.utils import profiling
from perfbench.families.indextts import trace_hook
from tests.test_torch_snake import clamp_pairs

DILS = (1, 3, 5)
# the C ≤ 128 stages of the 1536-channel BigVGAN, IndexTTS's and F5's alike
WIDTHS = (24, 48, 96)
F32_TOL = 1e-4          # chip_smoke.py's TOL[float32], relative to max|ref|
# IndexTTS's BigVGAN (speaker input) and F5's mel vocoder, cut to two
# stages of 136 and 68 channels: K1's stage and K2's (68 runs padded to 96)
IDX_CUT = BigVGANConfig(gpt_dim=64, upsample_initial_channel=272,
                        upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8))
MEL_CUT = MelVocoderConfig(upsample_initial_channel=272,
                           upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8))


class _Cfg:
    activation = "snakebeta"
    snake_logscale = True


def _resblock(g, c, k, dtype):
    conv = lambda: {"w": torch.randn(k, c, c, generator=g) * 0.1,
                    "b": torch.randn(c, generator=g) * 0.1}
    rb = {"convs1": [conv() for _ in range(3)],
          "convs2": [conv() for _ in range(3)],
          "acts": [{"alpha": torch.randn(c, generator=g) * 0.3,
                    "beta": torch.randn(c, generator=g) * 0.3}
                   for _ in range(6)]}
    return weights.cast_floating(rb, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 40, 150, 400])
@pytest.mark.parametrize("c", WIDTHS)
def test_k1_plain_exact_is_the_exact_route(c, t, dtype):
    g = torch.Generator().manual_seed(c + t)
    x = torch.randn(2, c, t, generator=g).to(dtype)
    al = (torch.randn(c, generator=g) * 0.3).to(dtype)
    be = (torch.randn(c, generator=g) * 0.3).to(dtype)
    want = downsample2(snake_beta(upsample2(x), al, be, True))
    got = k1.snake_cmajor(x, al, be, True, exact_edge=True)
    assert got.dtype == dtype and torch.equal(got, want)
    # the default mode is K1's own edge semantics, not the exact route's
    if t >= 8:
        assert not torch.equal(k1.snake_cmajor(x, al, be, True), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [30, 150, 400])
@pytest.mark.parametrize("k", [3, 11])
@pytest.mark.parametrize("c", WIDTHS)
def test_k2_plain_exact_is_the_exact_route(c, k, t, dtype):
    """Lengths under the chain span (48 at k = 3, 96 at k = 11), under twice
    it, and above; parameters and x in ``dtype`` (bfloat16 parameters fold
    their log-scale in bfloat16, as the exact route's snake_beta does)."""
    g = torch.Generator().manual_seed(c * k + t)
    rb = _resblock(g, c, k, dtype)
    x = (torch.randn(2, c, t, generator=g) * 0.5).to(dtype)
    want = voc_mod._resblock_cm(_Cfg(), rb, x, k, DILS, use_kernel=False)
    w = k2.pack_resblock(rb, _Cfg(), dtype, exact_edge=True)
    got = k2.resblock_cmajor(x, *w, k, DILS, exact_edge=True)
    assert got.dtype == dtype and torch.equal(got, want)


def test_k2_exact_pack_differs_only_in_the_fold_dtype():
    """float32 parameters pack alike in both modes; bfloat16 ones with a
    log-scale fold exp in bfloat16 for the exact-edge mode only."""
    g = torch.Generator().manual_seed(0)
    for dtype, same in ((torch.float32, True), (torch.bfloat16, False)):
        rb = _resblock(g, 24, 3, dtype)
        a = k2.pack_resblock(rb, _Cfg(), torch.float32)
        b = k2.pack_resblock(rb, _Cfg(), torch.float32, exact_edge=True)
        assert all(torch.equal(u, v) for u, v in zip(a[:4], b[:4]))
        assert torch.equal(a[4], b[4]) is same


# -- K2's block walk in exact-edge mode, emulated ---------------------------
def _act_valid(v, a, binv, g, t, edge):
    """csrc/resblock_cmajor.cuh's act_rows on (B, C, n) float32 → n - 12
    columns: pairs at src columns u = 3 .. n-3 (csrc/exact_edge.cuh's
    convention), the ×2 signal clamped at [0, t) when ``edge``; src column
    0 is the tensor's column g."""
    n = v.shape[-1]
    m = n - 5
    pe = sum(2.0 * float(UP_FILTER[11 - 2 * d]) * v[..., d: d + m]
             for d in range(6))
    po = sum(2.0 * float(UP_FILTER[10 - 2 * d]) * v[..., d: d + m]
             for d in range(6))
    pe = pe + binv * torch.sin(pe * a).square()
    po = po + binv * torch.sin(po * a).square()
    if edge:
        ce, co = clamp_pairs(pe.numpy(), po.numpy(), g + 3, t)
        pe, po = torch.from_numpy(ce), torch.from_numpy(co)
    nout = n - 12
    return sum(float(DOWN_FILTER[2 * q]) * po[..., 1 + q: 1 + q + nout]
               + float(DOWN_FILTER[2 * q + 1]) * pe[..., 1 + q: 1 + q + nout]
               for q in range(6))


def _pad(v, g, t, zero):
    """pad_rows: columns outside [0, t) to 0 or to the edge column's."""
    v = v.clone()
    n = v.shape[-1]
    lo, hi = min(max(-g, 0), n), min(max(t - g, 0), n)
    if lo:
        v[..., :lo] = 0.0 if zero else v[..., lo: lo + 1]
    if hi < n:
        v[..., hi:] = 0.0 if zero else v[..., hi - 1: hi]
    return v


def emulate_k2_exact(x, w1, b1, w2, b2, acts, k, dils, tt):
    """K2's exact-edge mode block by block in float32: Y holds x's columns
    [t0 - span, t0 + tt + span) (index clamped), and a block that reaches
    past an end pads each op's input there before running it valid."""
    b, c, t = x.shape
    span = k2.chain_shrink(k, dils)
    cp = w1.shape[-1]
    out = torch.empty_like(x)

    def conv(v, w, bias, d):
        wt = w.reshape(k, k2._cpad(cp), cp)[:, :c, :c].permute(2, 1, 0)
        return F.conv1d(v, wt, dilation=d) + bias[:c]

    for t0 in range(0, t, tt):
        gy = t0 - span
        edge = gy < 0 or t0 + tt + span > t
        y = x[..., (torch.arange(tt + 2 * span) + gy).clamp(0, t - 1)]
        off, width = 0, tt + 2 * span
        for p, d in enumerate(dils):
            g = gy + off
            ap = acts[p, :, :c]
            if edge:
                y[..., off: off + width] = _pad(y[..., off: off + width], g,
                                                t, False)
            v = _act_valid(y[..., off: off + width], ap[0], ap[1], g, t,
                           edge)
            g += 6
            v = conv(_pad(v, g, t, True) if edge else v, w1[p], b1[p], d)
            g += d * (k - 1) // 2
            v = _act_valid(_pad(v, g, t, False) if edge else v, ap[2], ap[3],
                           g, t, edge)
            g += 6
            v = conv(_pad(v, g, t, True) if edge else v, w2[p], b2[p], 1)
            s = k2._pair_shrink(k, d)
            y[..., off + s: off + s + v.shape[-1]] += v
            off += s
            width -= 2 * s
        n = min(tt, t - t0)
        out[..., t0: t0 + n] = y[..., off: off + n]
    return out


@pytest.mark.parametrize("k,t,tt", [(3, 20, 32), (3, 70, 32), (3, 130, 64),
                                    (7, 40, 64), (7, 300, 64),
                                    (11, 150, 32), (11, 150, 288),
                                    (11, 700, 96)])
def test_k2_exact_emulation_matches_exact_route(k, t, tt):
    """Tiles that reach both ends (T under the tile), one end, or neither,
    at each chain span (48/72/96); the default mode differs near the
    ends."""
    g = torch.Generator().manual_seed(k * t)
    c = 8
    rb = _resblock(g, c, k, torch.float32)
    x = torch.randn(2, c, t, generator=g) * 0.5
    w = k2.pack_resblock(rb, _Cfg(), torch.float32, exact_edge=True)
    got = emulate_k2_exact(x, *w, k, DILS, tt)
    want = k2.resblock_cmajor_plain(x, *w, k, DILS, exact_edge=True)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= F32_TOL * scale
    default = k2.resblock_cmajor_plain(x, *w, k, DILS)
    assert float((default - want).abs().max()) > 100 * F32_TOL * scale


# -- the vocoder's exact work on the kernel route ---------------------------
def _params(cfg, dtype=torch.float32, seed=0):
    p = weights.init_bigvgan(weights.Init(torch.Generator().manual_seed(seed),
                                          "cpu"), cfg)
    return weights.cast_floating(p, dtype)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_short_stream_and_patches_equal_the_plain_route(dtype):
    """IndexTTS's form (speaker input) in the parameters' dtype: a short
    stream vocoded whole and a long stream's two ends, on the kernel route
    (K1 and K2 in exact-edge mode, their plain versions here), equal the
    plain route's exact work bit for bit."""
    p = _params(IDX_CUT, dtype, seed=1)
    g = torch.Generator().manual_seed(2)
    spk = torch.randn(1, 1, IDX_CUT.speaker_embedding_dim, generator=g) * 0.1
    lat = torch.randn(1, 80, 64, generator=g) * 0.3
    kw = dict(window=16, halo=8, compute_dtype=dtype)
    fast = WindowedVocoder(p, IDX_CUT, **kw)
    plain = WindowedVocoder(p, IDX_CUT, use_pallas=False,
                            fuse_resblocks=False, edge_exact=True, **kw)
    with torch.no_grad():
        short = lat[0, :29].numpy()
        assert np.array_equal(fast(short, spk=spk), plain(short, spk=spk))
        wav = fast(lat[0].numpy(), spk=spk)
        pw, hu = 2 * fast.halo, fast.halo * fast.upsample
        ends = torch.stack([lat[0, :pw], lat[0, -pw:]]).to(dtype)
        want = plain._vocode(ends, spk, exact=True).float().numpy()
    assert np.array_equal(wav[:hu], want[0, :hu])
    assert np.array_equal(wav[-hu:], want[1, hu:])
    assert {key[1] for key in fast._packed} == {False, True}


def test_stream_rows_short_lines_equal_the_plain_route():
    """F5's form (no speaker input): ``stream_rows`` with two short lines
    and a long one; the short lines and the long line's two ends equal
    the plain route's exact work bit for bit."""
    p = _params(MEL_CUT, seed=3)
    g = torch.Generator().manual_seed(4)
    lat = torch.randn(3, 70, 100, generator=g)
    lens = [70, 25, 31]
    kw = dict(window=16, halo=8)
    fast = WindowedVocoder(p, MEL_CUT, **kw)
    plain = WindowedVocoder(p, MEL_CUT, use_pallas=False,
                            fuse_resblocks=False, edge_exact=True, **kw)
    with torch.no_grad():
        got = fast.stream_rows(lat, lens)
        want = plain.stream_rows(lat, lens)
        pw, hu = 2 * fast.halo, fast.halo * fast.upsample
        ends = plain._vocode(torch.stack([lat[0, :pw], lat[0, 70 - pw:70]]),
                             None, exact=True)
    for r in (1, 2):
        assert torch.equal(got[r], want[r])
    assert torch.equal(got[0][:hu], ends[0, :hu])
    assert torch.equal(got[0][-hu:], ends[1, hu:])


def test_exact_work_reaches_k2_by_name_with_k_fifth(monkeypatch):
    """At full width on meta tensors (nothing computed) an exact batch
    launches K1 55 times and K2 9 times, each in exact-edge mode; K2 is
    called as ``engine.vocoder.resblock_cmajor(x, w1, b1, w2, b2, acts, k,
    dils, exact_edge=True)``, and the benchmark's recorder reads its
    shapes."""
    cfg = BigVGANConfig(gpt_dim=64)
    p = weights.init_bigvgan(weights.Init(None, "meta"), cfg)
    calls = {"k1": [], "k2": []}

    def fake_k1(x, *a, **kw):
        calls["k1"].append(kw)
        return torch.empty_like(x)

    def fake_k2(x, *a, **kw):
        calls["k2"].append((a[5], kw))
        return torch.empty_like(x)

    monkeypatch.setattr(k1, "snake_cmajor", fake_k1)
    monkeypatch.setattr(voc_mod, "resblock_cmajor", fake_k2)
    voc = WindowedVocoder(p, cfg)
    with trace_hook() as launches:
        wav = voc._vocode(torch.empty(2, 32, 64, device="meta"),
                          torch.empty(1, 1, 512, device="meta"), exact=True)
    assert wav.shape == (2, 32 * 1024)
    assert len(calls["k1"]) == 55 and len(calls["k2"]) == 9
    assert all(kw == {"exact_edge": True} for kw in calls["k1"])
    assert all(kw == {"exact_edge": True} for _, kw in calls["k2"])
    assert [k for k, _ in calls["k2"]] == [3, 7, 11] * 3
    assert [(b, c, t, k) for b, c, t, k, _ in launches] == [
        (2, c, 32 * up, k) for c, up in ((96, 256), (48, 512), (24, 1024))
        for k in (3, 7, 11)]


@pytest.mark.parametrize("switches,launched", [((True, True), True),
                                               ((False, False), False)])
def test_exact_span_counts_kernel_launches(monkeypatch, switches, launched):
    """Under a profiler every ``vocoder.exact`` span reads
    ``kernel_launches``: the K1 and K2 launches inside it (counted here by
    wrappers that bump the kernels' own counters, since the CPU launches
    none), 0 on the plain route."""
    p = _params(IDX_CUT, seed=5)
    g = torch.Generator().manual_seed(6)
    spk = torch.randn(1, 1, IDX_CUT.speaker_embedding_dim, generator=g) * 0.1
    lat = torch.randn(1, 60, 64, generator=g) * 0.3
    orig1, orig2 = k1.snake_cmajor, voc_mod.resblock_cmajor
    n = {"calls": 0}

    def counted1(*a, **kw):
        n["calls"] += 1
        orig1.launches += 1
        return orig1(*a, **kw)

    def counted2(*a, **kw):
        n["calls"] += 1
        orig2.launches += 1
        return orig2(*a, **kw)

    monkeypatch.setattr(k1, "snake_cmajor", counted1)
    monkeypatch.setattr(voc_mod, "resblock_cmajor", counted2)
    monkeypatch.setattr(orig1, "launches", orig1.launches)
    monkeypatch.setattr(orig2, "launches", orig2.launches)
    use_pallas, fuse = switches
    voc = WindowedVocoder(p, IDX_CUT, window=16, halo=8,
                          use_pallas=use_pallas, fuse_resblocks=fuse,
                          edge_exact=True)
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("request"):
            voc(lat[0, :20].numpy(), spk=spk)          # whole, exact
        with profiling.span("request"):
            n["calls"] = 0
            voc(lat[0].numpy(), spk=spk)               # windows + patches
    reqs = profiling.requests()[-2:]
    exact = [s for r in reqs for s in r if s.name == "vocoder.exact"]
    # the plain route patches no ends: only the short stream is exact work
    assert len(exact) == 1 + launched
    if launched:      # 19 K1 (stage 0's 18 and act_post) + 3 K2 a batch
        assert [s.attrs["kernel_launches"] for s in exact] == [22, 22]
        assert n["calls"] > 22                       # the windows' too
    else:
        assert exact[0].attrs["kernel_launches"] == 0
