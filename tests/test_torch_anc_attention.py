"""Kernel K3, the beam step's ancestry attention (``ops/anc_attention.py``,
``csrc/anc_attention.cu``), and its plain version.

On the CPU: ``anc_attention_plain`` gives the bits of the torch chain that
``models/gpt.trunk_decode_step_split_anc`` ran a layer before the chain
moved behind the wrapper (written out here as ``_chain``), and the wrapper
takes the plain route for CPU tensors, launching nothing.

On the card (each test skips without one; the file imports no JAX, so run
it there with ``python -m pytest --noconftest
tests/test_torch_anc_attention.py``): K3 against the plain version at the
cells' shapes (the line's one row and the scene's 16, 3 beams, 16 heads of
64, prefixes of 40-110 slots with padded keys, 36-165 gen slots) and at the
small config's head dim 16, in bfloat16 and float32, at the first, a middle
and the last slot with a random ancestry map: the written K/V slot bit for
bit, o within ``_TOL`` (below); and the wrapper raising on what K3 does not
take.
"""
import math

import pytest
import torch

from index_tts_dubbing_tpu_torch.ops import anc_attention as k3

NB = 3


def _chain(qkv, kp, vp, kg, vg, slot, keep_p, amap, nb):
    """One layer of the beam step's attention as plain torch ops, the way
    the trunk step ran it inline: the slot writes, float32 scores against
    every physical beam, the ancestor's gathered, one softmax, the weights
    routed by a one-hot, two value products."""
    bn = qkv.shape[0]
    b = bn // nb
    h, s0, d = kp.shape[1:]
    g_len = kg.shape[3]
    pbias = torch.where(keep_p, 0.0, -1e30).float()[:, None, None, :]
    gbias = torch.where(torch.arange(g_len) <= slot, 0.0, -1e30).float()
    beams = torch.arange(nb, dtype=amap.dtype)
    amap_eff = torch.where(torch.arange(g_len) == slot, beams[None, :, None],
                           amap)
    pick = amap_eff[:, None, :, None, :].expand(b, h, nb, 1, g_len)
    onehot = (amap_eff[:, :, None, :] == beams[None, None, :, None]
              ).to(qkv.dtype)[:, None]
    heads_major = lambda t: t.reshape(b, nb, h, d).transpose(1, 2)
    q, k, v = qkv.chunk(3, dim=-1)
    kg.select(3, slot).copy_(heads_major(k))
    vg.select(3, slot).copy_(heads_major(v))
    qf = heads_major(q).float()
    lp = torch.matmul(qf, kp.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    s_all = (torch.matmul(qf, kg.float().reshape(b, h, nb * g_len, d)
                          .transpose(-1, -2)) * (1.0 / math.sqrt(d))
             ).reshape(b, h, nb, nb, g_len)
    lg = torch.gather(s_all, 3, pick)[:, :, :, 0]
    logits = torch.cat([lp + pbias, lg + gbias], dim=-1)
    w = torch.softmax(logits, dim=-1).to(qkv.dtype)
    wgm = (w[..., s0:][:, :, :, None, :] * onehot).reshape(b, h, nb,
                                                            nb * g_len)
    o = (torch.matmul(w[..., :s0], vp.to(qkv.dtype))
         + torch.matmul(wgm, vg.to(qkv.dtype).reshape(b, h, nb * g_len, d)))
    return o.transpose(1, 2).reshape(bn, h * d)


def _inputs(gen, b, h, d, s0, g_len, dtype, device, pads=5):
    """qkv, the prefix and gen caches, keep (row r pads its first
    (pads·r) % s0 keys, left-padded as the engine's prefixes are) and a
    random ancestry map."""
    r = lambda *shape: torch.randn(shape, generator=gen).to(dtype).to(device)
    keep = torch.ones((b, s0), dtype=torch.bool)
    for row in range(b):
        keep[row, :(pads * (row + 1)) % s0] = False
    amap = torch.randint(0, NB, (b, NB, g_len), generator=gen)
    return (1.5 * r(b * NB, 3 * h * d), r(b, h, s0, d), r(b, h, s0, d),
            r(b, h, NB, g_len, d), r(b, h, NB, g_len, d), keep.to(device),
            amap.to(device))


CPU_CASES = [(torch.float32, 2, 4, 16, 11, 16, 0),
             (torch.float32, 2, 4, 16, 11, 16, 6),
             (torch.float32, 1, 4, 16, 9, 12, 11),
             (torch.bfloat16, 2, 4, 16, 11, 16, 0),
             (torch.bfloat16, 2, 4, 16, 11, 16, 6),
             (torch.bfloat16, 1, 4, 16, 9, 12, 11)]
CPU_IDS = [f"{str(c[0])[6:]}-b{c[1]}-slot{c[6]}" for c in CPU_CASES]


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("dtype,b,h,d,s0,g_len,slot", CPU_CASES, ids=CPU_IDS)
def test_plain_is_the_chain_bit_for_bit(dtype, b, h, d, s0, g_len, slot,
                                        as_tensor):
    gen = torch.Generator().manual_seed(slot + 7 * b)
    qkv, kp, vp, kg, vg, keep, amap = _inputs(gen, b, h, d, s0, g_len, dtype,
                                              "cpu")
    kg2, vg2 = kg.clone(), vg.clone()
    want = _chain(qkv, kp, vp, kg, vg, slot, keep, amap, NB)
    at = torch.tensor(slot) if as_tensor else slot
    got = k3.anc_attention_plain(qkv, kp, vp, kg2, vg2, at, keep, amap, NB)
    assert got.dtype == dtype and got.shape == (b * NB, h * d)
    assert torch.equal(got, want)
    assert torch.equal(kg2, kg) and torch.equal(vg2, vg)


@pytest.mark.parametrize("dtype,b,h,d,s0,g_len,slot", CPU_CASES, ids=CPU_IDS)
def test_wrapper_takes_the_plain_route_on_the_cpu(dtype, b, h, d, s0, g_len,
                                                  slot):
    gen = torch.Generator().manual_seed(slot + 11 * b)
    qkv, kp, vp, kg, vg, keep, amap = _inputs(gen, b, h, d, s0, g_len, dtype,
                                              "cpu")
    kg2, vg2 = kg.clone(), vg.clone()
    before = k3.anc_attention.launches
    got = k3.anc_attention(qkv, kp, vp, kg, vg, torch.tensor(slot), keep,
                           amap, NB)
    assert k3.anc_attention.launches == before
    want = k3.anc_attention_plain(qkv, kp, vp, kg2, vg2, slot, keep, amap, NB)
    assert torch.equal(got, want)
    assert torch.equal(kg, kg2) and torch.equal(vg, vg2)


@pytest.mark.parametrize("b,h,resident,split",
                         [(1, 16, 528, 8), (16, 16, 528, 2),
                          (16, 16, 396, 1), (1, 8, 264, 8), (2, 16, 264, 8),
                          (4, 16, 264, 4), (8, 16, 264, 2), (64, 16, 264, 1)])
def test_split_fills_the_card(b, h, resident, split):
    """The cluster size is read from B·H against the CTAs the card holds
    at once: the line's 16 pairs split 8 ways, the scene's 256 in two where
    the card holds two of their CTAs an SM, and never past 8 or below 1."""
    assert k3.split_of(b, h, resident) == split


@pytest.mark.parametrize("d,size,groups", [(64, 2, 32), (64, 4, 16),
                                           (16, 2, 128), (128, 4, 8)])
def test_lane_groups(d, size, groups):
    assert k3.lane_groups(d, size) == groups


# o against the plain version, per dtype, as a share of max |o|. float32:
# the two sum the same float32 products in another order (D-term dots, a
# softmax over <= 275 keys, the value sums), each ~1e-7 relative. bfloat16:
# K3 rounds o once where the plain chain rounds two products and their sum
# (~2 ulp of 2^-8), and a weight whose float32 value lies at a bf16
# rounding edge may round the other way.
_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (B, H, D, S0, G): the line's one row at a short and a long cap, the
# scene's 16 rows at cap 164, IndexTTS-2's scene (16 rows of 20 heads, 34
# conditioning rows + a 40-token line + start/stop + start_mel, cap 350),
# and the small config's head dim
CARD_SHAPES = [(1, 16, 64, 40, 36), (1, 16, 64, 110, 165),
               (16, 16, 64, 70, 165), (16, 16, 64, 110, 165),
               (16, 20, 64, 77, 350), (4, 4, 16, 33, 72)]


@pytest.mark.card
@pytest.mark.parametrize("where", ["first", "mid", "last"])
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_k3_matches_plain(cuda, dtype, shape, where):
    b, h, d, s0, g_len = shape
    slot = {"first": 0, "mid": g_len // 2, "last": g_len - 1}[where]
    gen = torch.Generator().manual_seed(sum(shape) + slot)
    qkv, kp, vp, kg, vg, keep, amap = _inputs(gen, b, h, d, s0, g_len, dtype,
                                              cuda)
    kg2, vg2 = kg.clone(), vg.clone()
    before = k3.anc_attention.launches
    got = k3.anc_attention(qkv, kp, vp, kg, vg,
                           torch.tensor(slot, device=cuda), keep, amap, NB)
    torch.cuda.synchronize()
    assert k3.anc_attention.launches == before + 1
    want = k3.anc_attention_plain(qkv, kp, vp, kg2, vg2, slot, keep, amap, NB)
    assert torch.equal(kg, kg2) and torch.equal(vg, vg2)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= _TOL[dtype] * scale, (err, scale)


@pytest.mark.card
def test_k3_raises_on_what_it_does_not_take(cuda):
    gen = torch.Generator().manual_seed(0)
    args = list(_inputs(gen, 1, 4, 16, 20, 24, torch.float32, cuda))
    slot = torch.tensor(3, device=cuda)

    def call(**over):
        a = dict(zip(("qkv", "kp", "vp", "kg", "vg", "keep_p", "amap"), args))
        a.update(over)
        return k3.anc_attention(a["qkv"], a["kp"], a["vp"], a["kg"], a["vg"],
                                slot, a["keep_p"], a["amap"], NB)

    with pytest.raises(TypeError):                          # dtype
        call(**{n: t.half() for n, t in zip(("qkv", "kp", "vp", "kg", "vg"),
                                             args)})
    with pytest.raises(TypeError):                          # mixed dtypes
        call(kp=args[1].bfloat16())
    g2 = torch.Generator().manual_seed(1)
    odd = _inputs(g2, 1, 4, 24, 20, 24, torch.float32, cuda)
    with pytest.raises(ValueError):                         # head dim 24
        k3.anc_attention(*odd[:5], slot, *odd[5:], NB)
    with pytest.raises(ValueError):                         # kg's layout
        call(kg=args[3].transpose(3, 4).contiguous().transpose(3, 4))
    with pytest.raises(ValueError):                         # qkv's layout
        call(qkv=args[0].t().contiguous().t())
    with pytest.raises(TypeError):                          # amap's dtype
        call(amap=args[6].int())
    g3 = torch.Generator().manual_seed(2)
    wide = _inputs(g3, 1, 4, 128, 20, 24, torch.float32, cuda)
    with pytest.raises(ValueError):                         # 9 beams > 8
        k3.anc_attention(torch.randn(9, 3 * 4 * 128, device=cuda),
                         *wide[1:3], torch.randn(1, 4, 9, 24, 128,
                                                 device=cuda),
                         torch.randn(1, 4, 9, 24, 128, device=cuda), slot,
                         wide[5], torch.zeros(1, 9, 24, dtype=torch.long,
                                              device=cuda), 9)
