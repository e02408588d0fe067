"""Kernels K1 (csrc/snake_cmajor.cu) and B3 (csrc/snake_clast.cu) on the
CPU, torch and numpy only:

- the range-reduced sin² of csrc/snake_math.cuh, mirrored step by step in
  float32, against float64 sin² (bound stated below);
- K1's plain chain with that sin in place of ``torch.sin``, within
  chip_smoke.py's float32 ``TOL`` of the plain version;
- the kernels' own folding of SnakeBeta's raw parameters, equal to
  ``fold_params``;
- the launch plans (``snake_cmajor.lane_plan``, ``snake_clast.run_plan``):
  the lanes and runs stitched cover every row, time and channel exactly
  once, and a float32 emulation of each kernel's walk over its plan (K1's
  lanes with their shuffles, B3's register rings) equals the plain version;
  K1's walk in its exact-edge mode (csrc/exact_edge.cuh's pair clamp in the
  lanes that reach a row's end) equals the exact route.
"""
import math
from unittest import mock

import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu_torch.ops import snake_clast as b3
from index_tts_dubbing_tpu_torch.ops import snake_cmajor as k1
from index_tts_dubbing_tpu_torch.ops.alias_free import UP_FILTER

F32_TOL = 1e-4          # chip_smoke.py's TOL[float32], relative to max|plain|
# |sin2(y) - sin²(y)| over |y| <= 2^15: 3.4e-7 observed; the accurate float32
# sin, squared, is within 1.3e-7. Rounding in the reduction and Horner steps,
# not the degree-11 truncation (5.7e-8 at π/2), sets it.
SIN2_BOUND = 5e-7
T_CASES = (1, 5, 63, 576, 577, 2304, 9216)

f32 = np.float32
# csrc/snake_math.cuh's constants, rounded to float32 as nvcc rounds them
LIMIT = f32(32768.0)
INV_PI = f32(0.318309886183790672)
PI_HI = f32(3.14159274101257324)
PI_LO = f32(-8.74227766e-08)
S3, S5, S7, S9, S11 = (f32((-1) ** n) / f32(math.factorial(2 * n + 1))
                       for n in range(1, 6))


def _fma(a, b, c):
    """float32 fmaf: the product is exact in float64 (24 + 24 bits); the
    sum rounds to float64 and then float32, which can differ from one
    rounding in the last bit only."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f32)


def sin_reduced(y):
    """The polynomial value s of sin2 (s² is its result below the limit):
    ±sin(y), float32, in the .cuh's order of operations."""
    y = np.asarray(y, f32)
    k = np.rint(y * INV_PI).astype(f32)
    r = _fma(-k, PI_HI, y)
    r = _fma(-k, PI_LO, r)
    r2 = r * r
    p = _fma(S11, r2, S9)
    p = _fma(p, r2, S7)
    p = _fma(p, r2, S5)
    p = _fma(p, r2, S3)
    return _fma(r * r2, p, r)


def sin2(y):
    y = np.asarray(y, f32)
    s = sin_reduced(y)
    big = np.abs(y) > LIMIT
    s = np.where(big, np.sin(y).astype(f32), s)
    return s * s


def _sin_as_kernel(t: torch.Tensor) -> torch.Tensor:
    """``torch.sin`` replaced by the kernel's sine: only its square is used
    by the snake, and sin2 squares ±sin(y)."""
    y = t.numpy()
    s = sin_reduced(y)
    s = np.where(np.abs(y) > LIMIT, np.sin(y).astype(f32), s)
    return torch.from_numpy(s)


def test_sin2_constants_are_the_float32_roundings():
    assert PI_HI == f32(math.pi) and PI_LO == f32(math.pi - float(PI_HI))
    assert INV_PI == f32(1 / math.pi)


def test_sin2_matches_float64_within_its_bound():
    grid = np.linspace(-2.0 ** 15, 2.0 ** 15, 4_000_001).astype(f32)
    halves = (np.arange(-20861, 20862) * (math.pi / 2)).astype(f32)
    edges = np.array([LIMIT, -LIMIT, np.nextafter(LIMIT, f32(0)),
                      np.nextafter(LIMIT, f32(np.inf)), 0.0], f32)
    small = np.linspace(-4.0, 4.0, 400_001).astype(f32)
    y = np.concatenate([grid, halves, edges, small])
    err = np.abs(sin2(y).astype(np.float64) - np.sin(np.float64(y)) ** 2)
    assert err.max() <= SIN2_BOUND
    # past the limit the accurate sine takes over
    big = np.array([4e4, -1e6, 3.3e8], f32)
    assert np.array_equal(sin2(big), np.sin(big).astype(f32) ** 2)
    with np.errstate(invalid="ignore"):
        assert np.isnan(sin2(np.array([np.nan, np.inf], f32))).all()


def _params(rng, c):
    alpha = torch.from_numpy((rng.standard_normal(c) * 0.3).astype(f32))
    beta = torch.from_numpy((rng.standard_normal(c) * 0.3).astype(f32))
    return alpha, beta


@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("b,c,t", [(2, 16, 577), (1, 24, 5), (3, 8, 1),
                                   (2, 4, 2304)])
def test_plain_chain_with_the_kernel_sine_is_within_tol(rng, b, c, t,
                                                        logscale):
    x = torch.from_numpy(rng.standard_normal((b, c, t)).astype(f32))
    alpha, beta = _params(rng, c)
    if not logscale:              # α, β as trained without the log-scale
        alpha, beta = alpha.exp(), beta.exp()
    ref = k1.snake_cmajor_plain(x, alpha, beta, logscale)
    with mock.patch.object(k1.torch, "sin", _sin_as_kernel):
        got = k1.snake_cmajor_plain(x, alpha, beta, logscale)
    lim = F32_TOL * max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= lim


def fold_as_kernel(alpha, beta, logscale):
    """csrc/snake_math.cuh ``fold``: the raw parameters in float32, exp'd and
    rounded to their own dtype when log-scale (beta absent: alpha), binv =
    1 / (b + 1e-9) in float32."""
    al = alpha.float()
    be = beta.float() if beta is not None else al
    if logscale:
        al = al.exp().to(alpha.dtype).float()
        be = be.exp().to(alpha.dtype).float()
    return al, 1.0 / (be + 1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_beta", [True, False])
@pytest.mark.parametrize("logscale", [True, False])
def test_kernel_fold_equals_fold_params(rng, dtype, with_beta, logscale):
    alpha, beta = _params(rng, 24)
    alpha = alpha.to(dtype)
    beta = beta.to(dtype) if with_beta else None
    want = k1.fold_params(alpha, beta, logscale, 24)
    got = fold_as_kernel(alpha, beta, logscale)
    assert all(torch.equal(w, g) for w, g in zip(want, got))


# --- K1: the lane plan and a float32 emulation of the kernel's walk ---------

def _k1_lanes(rows, t):
    """(row, first output, live, lane) of every lane of every pass, in the
    kernel's order, from lane_plan (passes along axis 0)."""
    lanes, passes, _ = k1.lane_plan(rows, t, 1 << 30)
    v = (np.arange(passes)[:, None] * k1.STORING_LANES
         + np.arange(32)[None, :])
    vrow = v // lanes
    tb = (v - vrow * lanes) * k1.RUN
    live = vrow < rows
    return np.where(live, vrow, rows - 1), tb, live, np.arange(32)[None, :]


@pytest.mark.parametrize("t", T_CASES)
@pytest.mark.parametrize("rows", [1, 3, 40])
def test_k1_lanes_store_every_output_once(rows, t):
    row, tb, live, lane = _k1_lanes(rows, t)
    stores = live & (lane < k1.STORING_LANES) & (tb < t)
    hits = np.zeros((rows, t), np.int64)
    for r, s in zip(row[stores], tb[stores]):
        hits[r, s: min(s + k1.RUN, t)] += 1
    assert (hits == 1).all()
    # each storing lane's pairs continue in the next lane of its pass
    nxt_row = np.roll(row, -1, axis=1)
    nxt_tb = np.roll(tb, -1, axis=1)
    assert (nxt_row[stores] == row[stores]).all()
    assert (nxt_tb[stores] == tb[stores] + k1.RUN).all()


@pytest.mark.parametrize("resident", [1, 7, 2112, 1 << 30])
def test_k1_warps_walk_every_pass_once(resident):
    lanes, passes, chunk = k1.lane_plan(3072, 576, resident)
    assert lanes == 576 // k1.RUN + 1
    warps = -(-passes // chunk)
    assert warps <= resident and (warps - 1) * chunk < passes
    walked = np.concatenate([np.arange(w * chunk, min((w + 1) * chunk, passes))
                             for w in range(warps)])
    assert np.array_equal(walked, np.arange(passes))


def _taps():
    f = np.asarray(UP_FILTER, f32)
    up_e = np.array([2 * f[11 - 2 * q] for q in range(6)], f32)
    up_o = np.array([2 * f[10 - 2 * q] for q in range(6)], f32)
    return up_e, up_o, f[1::2].copy(), f[0::2].copy()   # dn_e, dn_o


def _snake(v, av, bv):
    return v + bv * sin2(v * av)


def clamp_pairs(pe, po, g, t):
    """csrc/exact_edge.cuh's ``clamp_pairs`` over the last axis: pairs
    u = g + j (g broadcast over the leading axes), the ×2 signal
    replicate-padded at [0, t)'s ends."""
    u = np.asarray(g)[..., None] + np.arange(pe.shape[-1])
    e0 = np.where(u == 0, pe, 0).sum(-1, keepdims=True)
    o_t = np.where(u == t, po, 0).sum(-1, keepdims=True)
    pe, po = np.where(u < 0, e0, pe), np.where(u <= 0, e0, po)
    return np.where(u >= t, o_t, pe), np.where(u > t, o_t, po)


def emulate_k1(x, a, binv, resident, exact=False):
    """K1's kernel in numpy float32 over (rows, T) = x, lane by lane (a
    pass's lanes along axis 1, shuffles as rolls along it), its warps
    walking chunks of passes from lane_plan; ``exact``: its exact-edge
    mode."""
    rows, t = x.shape
    c = a.shape[0]
    up_e, up_o, dn_e, dn_o = _taps()
    row, tb, live, lane = _k1_lanes(rows, t)
    chunk = k1.lane_plan(rows, t, resident)[2]
    run, halo = k1.RUN, 5
    clamp = lambda i: np.clip(i, 0, t - 1)
    own = x[row[..., None], clamp(tb[..., None] + np.arange(run))]
    # lane 0's inputs before its run: read at a chunk's first pass, else
    # lane 30's tail in the pass before
    read = x[row[:, 0, None], clamp(tb[:, 0, None] - halo + np.arange(halo))]
    carried = np.roll(own[:, 30, run - halo:], 1, axis=0)
    first = (np.arange(row.shape[0]) % chunk == 0)[:, None]
    below = np.where(first, read, carried)
    h = np.roll(own[..., run - halo:], 1, axis=1)              # shfl_up 1
    h[:, 0] = below
    h = np.where((tb == 0)[..., None], own[..., :1], h)
    xv = np.concatenate([h, own], -1)
    av = a[row % c][..., None]
    bv = binv[row % c][..., None]
    e = sum(up_e[d] * xv[..., d: d + run] for d in range(6))
    o = sum(up_o[d] * xv[..., d: d + run] for d in range(6))
    pe = np.concatenate([_snake(e, av, bv), np.zeros_like(e[..., :halo])], -1)
    po = np.concatenate([_snake(o, av, bv), np.zeros_like(o[..., :halo])], -1)
    pe[..., run:] = np.roll(pe[..., :halo], -1, axis=1)         # shfl_down 1
    po[..., run:] = np.roll(po[..., :halo], -1, axis=1)
    if exact:                  # pair r is u = tb - 2 + r
        ends = ((tb == 0) | (tb + run + 2 >= t))[..., None]
        ce, co = clamp_pairs(pe, po, tb - 2, t)
        pe, po = np.where(ends, ce, pe), np.where(ends, co, po)
    y = sum(dn_o[q] * po[..., q: q + run] + dn_e[q] * pe[..., q: q + run]
            for q in range(6))
    out = np.full((rows, t), np.nan, f32)
    stores = live & (lane < k1.STORING_LANES) & (tb < t)
    for r, s, vals in zip(row[stores], tb[stores], y[stores]):
        n = min(k1.RUN, t - s)
        out[r, s: s + n] = vals[:n]
    return out


@pytest.mark.parametrize("resident", [2, 1 << 30])   # long chunks, one pass
@pytest.mark.parametrize("b,c,t", [(2, 3, 577), (1, 4, 5), (3, 2, 1),
                                   (1, 2, 63), (1, 2, 576)])
def test_k1_emulation_matches_plain(rng, b, c, t, resident):
    x = rng.standard_normal((b, c, t)).astype(f32)
    alpha, beta = _params(rng, c)
    a, binv = k1.fold_params(alpha, beta, True, c)
    got = emulate_k1(x.reshape(b * c, t), a.numpy(), binv.numpy(), resident)
    ref = k1.snake_cmajor_plain(torch.from_numpy(x), alpha, beta, True)
    ref = ref.numpy().reshape(b * c, t)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= F32_TOL * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("resident", [2, 1 << 30])
@pytest.mark.parametrize("b,c,t", [(2, 3, 577), (1, 4, 5), (3, 2, 1),
                                   (2, 2, 2), (1, 2, 63), (1, 2, 576),
                                   (2, 3, 11)])
def test_k1_exact_emulation_matches_exact_route(rng, b, c, t, resident):
    """K1's exact-edge mode against the exact route's activation, rows of
    every length class (shorter than a run, one lane and a helper, ragged
    and whole last runs); the default mode differs within ±3 frames."""
    x = rng.standard_normal((b, c, t)).astype(f32)
    alpha, beta = _params(rng, c)
    a, binv = k1.fold_params(alpha, beta, True, c)
    got = emulate_k1(x.reshape(b * c, t), a.numpy(), binv.numpy(), resident,
                     exact=True)
    ref = k1.snake_cmajor_plain(torch.from_numpy(x), alpha, beta, True,
                                exact_edge=True)
    ref = ref.numpy().reshape(b * c, t)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= F32_TOL * max(1.0, np.abs(ref).max())
    default = emulate_k1(x.reshape(b * c, t), a.numpy(), binv.numpy(),
                         resident)
    inner = slice(3, t - 3)
    assert np.abs(default[:, inner] - got[:, inner]).max(initial=0) <= \
        F32_TOL * max(1.0, np.abs(ref).max())


# --- B3: the run plan and a float32 emulation of the kernel's walk ----------

# threads an H100 holds at once of three 128-thread blocks per SM (B3 at up
# to 170 registers)
RESIDENT = 132 * 384


def _b3_threads(b, t, c, vec, resident=RESIDENT):
    run, runs, threads = b3.run_plan(b, t, c, vec, resident)
    g = np.arange(threads)
    nv = c // vec
    rest = g // nv
    return (rest // runs, (g % nv) * vec, (rest % runs) * run,
            np.minimum(run, t - (rest % runs) * run))


@pytest.mark.parametrize("t", T_CASES)
@pytest.mark.parametrize("c", [6, 24, 48, 768])
def test_b3_runs_store_every_output_once(t, c):
    b = 2
    vec = b3.vec_width(c, (0, 64), 4)
    assert vec == (1 if c % 4 else b3.VEC)
    run, runs, threads = b3.run_plan(b, t, c, vec, RESIDENT)
    assert run % b3.RING == 0 and run <= b3.MAX_RUN
    assert (runs - 1) * run < t <= runs * run
    hits = np.zeros((b, t, c), np.int64)
    for bb, c0, t0, n in zip(*_b3_threads(b, t, c, vec)):
        assert n >= 1
        hits[bb, t0: t0 + n, c0: c0 + vec] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("c,t,run", [(768, 576, 12), (384, 2304, 18),
                                     (192, 9216, 36), (96, 36864, 72),
                                     (48, 73728, 72), (24, 147456, 72)])
def test_b3_plan_fills_whole_waves(c, t, run):
    """A window batch's shapes take the shortest run that keeps the grid
    to one wave: at least 70% full (768 x 576: 12 times a run, 73%; half
    the run would take two waves)."""
    got, runs, threads = b3.run_plan(4, t, c, b3.VEC, RESIDENT)
    assert got == run and threads <= RESIDENT
    assert threads >= 0.7 * RESIDENT


def test_b3_vector_width_needs_aligned_pointers():
    assert b3.vec_width(768, (0, 16), 4) == b3.VEC
    assert b3.vec_width(768, (4, 16), 4) == 1
    assert b3.vec_width(768, (8, 16), 2) == b3.VEC
    assert b3.vec_width(6, (0, 16), 4) == 1


def emulate_b3(x, a, binv, vec, resident):
    """B3's kernel in numpy float32 over x (B, T, C): every thread's ring
    walk, the threads advanced together."""
    bsz, t, c = x.shape
    up_e, up_o, dn_e, dn_o = _taps()
    bb, c0, t0, n = _b3_threads(bsz, t, c, vec, resident)
    ch = c0[:, None] + np.arange(vec)[None, :]
    av, bv = a[ch], binv[ch]
    load = lambda tt: x[bb[:, None], np.clip(tt, 0, t - 1)[:, None], ch]
    X = [load(t0 - 5 + p) for p in range(6)]
    N = [load(t0 + 5 + k) for k in range(6)]
    PE, PO = [None] * 6, [None] * 6

    def pair(first, slot):
        xs = [X[(first + d) % 6] for d in range(6)]
        e = sum(up_e[d] * xs[d] for d in range(6))
        o = sum(up_o[d] * xs[d] for d in range(6))
        PE[slot], PO[slot] = _snake(e, av, bv), _snake(o, av, bv)

    pair(0, 0)
    for q in range(1, 5):
        X[(q + 5) % 6] = load(t0 + q)
        pair(q, q)
    out = np.full(x.shape, np.nan, f32)
    for s in range(0, int(n.max()), 6):
        for k in range(6):
            X[(k + 4) % 6] = N[k]
            N[k] = load(t0 + s + k + 11)
            pair(k + 5, (k + 5) % 6)
            y = sum(dn_o[q] * PO[(k + q) % 6] + dn_e[q] * PE[(k + q) % 6]
                    for q in range(6))
            ok = s + k < n
            out[bb[ok, None], (t0 + s + k)[ok, None], ch[ok]] = y[ok]
    return out


@pytest.mark.parametrize("resident", [1, 10 ** 9])   # longest, shortest run
@pytest.mark.parametrize("b,t,c", [(1, 1000, 6), (2, 577, 8), (1, 1, 24),
                                   (1, 13, 4)])
def test_b3_emulation_matches_plain(rng, b, t, c, resident):
    x = rng.standard_normal((b, t, c)).astype(f32)
    alpha, beta = _params(rng, c)
    a, binv = k1.fold_params(alpha, beta, True, c)
    vec = b3.vec_width(c, (0,), 4)
    run = b3.run_plan(b, t, c, vec, resident)[0]
    assert run == b3.RING if resident > 1 or t <= b3.RING else run >= 12
    got = emulate_b3(x, a.numpy(), binv.numpy(), vec, resident)
    ref = b3.snake_clast_plain(torch.from_numpy(x), alpha, beta, True).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= F32_TOL * max(1.0, np.abs(ref).max())
