"""Kernel K3: the beam decode step's ancestry attention, one launch a layer.

Replaces no TPU kernel: the JAX package's beam step
(index_tts_dubbing_tpu/models/gpt.py, ``trunk_decode_step_split_anc``) is
plain XLA ops, as ``anc_attention_plain`` is plain PyTorch. K3 (CUDA source
``csrc/anc_attention.cu``) runs the same function in one launch: it writes
the step's k and v at gen slot ``slot``, reads q, k and v from the qkv
product by strides, routes each gen slot through the ancestry map, reads no
slot past ``slot``, and writes o in the layout the output projection takes.
What bounds it on the H100 and how its design meets that is in the source.

Numerics, as the plain chain's at the caller's precision: scores and
softmax in float32 from the cache's values upcast exactly; the weights
rounded to the compute dtype before the value product; the products
accumulated in float32 (full-float32 FMAs, no TF32). The kernel rounds o
once, where the plain chain rounds each of its two value products and
their sum, so in bfloat16 the two differ by an ulp of o at most.

``anc_attention`` launches K3 for a CUDA tensor and takes the plain version
only for a CPU tensor. ``split_of``: the CTAs of a thread-block cluster
that share one (row, head) pair's keys, from B·H against the CTAs the card
holds at once.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.ops import cuda_lib

# a cache slot: a host int, or a 0-d int64 device tensor (a step counter
# that lives on the device, as under a CUDA graph)
Slot = Union[int, torch.Tensor]
_NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128)       # the head dims K3 is built for
MAX_SPLIT = 8                       # the portable cluster size
THREADS = 256                       # a CTA's threads (kThreads)


def _split_biases(keep_p: torch.Tensor, g_len: int, slot: Slot
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Additive float32 biases: prefix (B, 1, 1, S0) from the pad mask, gen
    (G,) opening slots <= ``slot``."""
    pbias = torch.where(keep_p, 0.0, _NEG).float()[:, None, None, :]
    ar = torch.arange(g_len, device=keep_p.device)
    return pbias, torch.where(ar <= slot, 0.0, _NEG).float()


def _amap_eff(amap: torch.Tensor, slot: Slot, nb: int) -> torch.Tensor:
    """The ancestry map with column ``slot`` stamped identity: the current
    step writes physical beam == logical beam there (the decode loop
    composes the map after selection)."""
    beams = torch.arange(nb, device=amap.device, dtype=amap.dtype)
    at_slot = torch.arange(amap.shape[2], device=amap.device) == slot
    return torch.where(at_slot, beams[None, :, None], amap)


def _anc_onehot(amap_eff: torch.Tensor, nb: int) -> torch.Tensor:
    """(B, nb_log, nb_phys, S) bool: physical beam m holds logical beam n's
    slot s."""
    beams = torch.arange(nb, device=amap_eff.device, dtype=amap_eff.dtype)
    return amap_eff[:, :, None, :] == beams[None, None, :, None]


def _heads_major(t: torch.Tensor, b: int, nb: int, h: int, d: int
                 ) -> torch.Tensor:
    """(B·nb, H·D) → (B, H, nb, D)."""
    return t.reshape(b, nb, h, d).transpose(1, 2)


def anc_attention_plain(qkv: torch.Tensor, kp: torch.Tensor,
                        vp: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor,
                        slot: Slot, keep_p: torch.Tensor, amap: torch.Tensor,
                        nb: int) -> torch.Tensor:
    """The plain PyTorch version of K3: the step's k and v written into
    ``kg``/``vg`` at ``slot`` in place, then o (B·nb, H·D). Scores are
    computed against every physical beam of the row and the ancestor's is
    selected; the value product applies the same selection to the
    probabilities."""
    bn = qkv.shape[0]
    b = bn // nb
    h, s0, d = kp.shape[1:]
    g_len = kg.shape[3]
    pbias, gbias = _split_biases(keep_p, g_len, slot)
    scale = 1.0 / math.sqrt(d)
    amap_eff = _amap_eff(amap, slot, nb)                        # (B, nb, G)
    pick = amap_eff[:, None, :, None, :].expand(b, h, nb, 1, g_len)
    onehot = _anc_onehot(amap_eff, nb).to(qkv.dtype)[:, None]   # (B,1,n,m,G)
    q, k, v = qkv.chunk(3, dim=-1)
    nn.write_slot(kg, 3, slot, _heads_major(k, b, nb, h, d))
    nn.write_slot(vg, 3, slot, _heads_major(v, b, nb, h, d))
    qf = _heads_major(q, b, nb, h, d).float()                    # (B, H, nb, D)
    lp = torch.matmul(qf, kp.float().transpose(-1, -2)) * scale
    kgf = kg.float().reshape(b, h, nb * g_len, d)
    s_all = (torch.matmul(qf, kgf.transpose(-1, -2)) * scale
             ).reshape(b, h, nb, nb, g_len)
    lg = torch.gather(s_all, 3, pick)[:, :, :, 0]       # the ancestor's score
    logits = torch.cat([lp + pbias, lg + gbias], dim=-1)       # (B,H,nb,S0+G)
    w = torch.softmax(logits, dim=-1).to(qkv.dtype)
    wp, wg = w[..., :s0], w[..., s0:]
    wgm = (wg[:, :, :, None, :] * onehot).reshape(b, h, nb, nb * g_len)
    vgx = vg.to(qkv.dtype).reshape(b, h, nb * g_len, d)
    o = (torch.matmul(wp, vp.to(qkv.dtype))
         + torch.matmul(wgm, vgx))                      # (B, H, nb, D)
    return o.transpose(1, 2).reshape(bn, h * d)


def split_of(b: int, h: int, resident_ctas: int) -> int:
    """CTAs a (row, head) pair takes: as many as B·H pairs leave room for
    among the ``resident_ctas`` the card holds at once, 1-``MAX_SPLIT``."""
    return max(1, min(MAX_SPLIT, resident_ctas // (b * h)))


def resident_ctas(device: torch.device, dtype: torch.dtype, d: int) -> int:
    """K3's CTAs the card holds at once at head dim ``d`` in ``dtype``."""
    code = cuda_lib.DTYPE_CODES[dtype]
    return cuda_lib.resident_threads("anc_attention_resident", device, code,
                                     d) // THREADS


def lane_groups(d: int, element_size: int) -> int:
    """K3's lane groups a CTA, each reading a key row as 16-byte vectors:
    the most beams a launch takes."""
    return THREADS * 16 // (d * element_size)


def anc_attention(qkv: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                  kg: torch.Tensor, vg: torch.Tensor, slot: Slot,
                  keep_p: torch.Tensor, amap: torch.Tensor,
                  nb: int) -> torch.Tensor:
    """One layer's ancestry attention of the beam step. qkv (B·nb, 3·H·D),
    the qkv product of the current tokens; kp, vp (B, H, S0, D) the prefix
    cache; kg, vg (B, H, nb, G, D) the gen cache in the ancestry layout,
    written at ``slot`` in place; keep_p (B, S0) prefix validity; amap (B,
    nb, G) the ancestry map; ``slot`` a host int or a 0-d int64 device
    tensor. Returns o (B·nb, H·D): kernel K3 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if qkv.device.type == "cpu":
        return anc_attention_plain(qkv, kp, vp, kg, vg, slot, keep_p, amap,
                                   nb)
    if qkv.device.type != "cuda":
        raise ValueError(f"anc_attention: unsupported device {qkv.device}")
    dev, dt = qkv.device, qkv.dtype
    code = cuda_lib.dtype_code(qkv)
    if kp.dim() != 4:
        raise ValueError(f"anc_attention: kp must be (B, H, S0, D), got "
                         f"{tuple(kp.shape)}")
    b, h, s0, d = kp.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"anc_attention: head dim {d}; K3 is built for "
                         f"{HEAD_DIMS}")
    if nb > lane_groups(d, qkv.element_size()):
        raise ValueError(f"anc_attention: {nb} beams; K3 takes at most "
                         f"{lane_groups(d, qkv.element_size())} at head dim "
                         f"{d} in {dt}")
    g_len = kg.shape[-2] if kg.dim() == 5 else -1
    vec = 16 // qkv.element_size()
    if (qkv.dim() != 2 or qkv.shape != (b * nb, 3 * h * d)
            or qkv.stride(1) != 1 or qkv.stride(0) % vec
            or qkv.data_ptr() % 16):
        raise ValueError(f"anc_attention: qkv must be ({b * nb}, {3 * h * d}) "
                         "with unit stride along its rows, 16-byte aligned; "
                         f"got {tuple(qkv.shape)} strides {qkv.stride()}")
    for name, t, shape in (("kp", kp, (b, h, s0, d)), ("vp", vp, (b, h, s0, d)),
                           ("kg", kg, (b, h, nb, g_len, d)),
                           ("vg", vg, (b, h, nb, g_len, d))):
        cuda_lib.require(t, name, dev, dt, shape)
        if t.data_ptr() % 16:
            raise ValueError(f"anc_attention: {name} must be 16-byte aligned")
    cuda_lib.require(keep_p, "keep_p", dev, torch.bool, (b, s0))
    cuda_lib.require(amap, "amap", dev, torch.int64, (b, nb, g_len))
    if not torch.is_tensor(slot):
        slot = torch.full((), slot, dtype=torch.int64, device=dev)
    cuda_lib.require(slot, "slot", dev, torch.int64, ())
    out = torch.empty((b * nb, h * d), dtype=dt, device=dev)
    rc = cuda_lib.load().anc_attention(
        qkv.data_ptr(), kp.data_ptr(), vp.data_ptr(), kg.data_ptr(),
        vg.data_ptr(), keep_p.data_ptr(), amap.data_ptr(), slot.data_ptr(),
        out.data_ptr(), qkv.stride(0), b, h, nb, s0, g_len, d,
        split_of(b, h, resident_ctas(dev, dt, d)), code,
        cuda_lib.stream_ptr(dev))
    cuda_lib.check(rc, "anc_attention")
    anc_attention.launches += 1
    return out


anc_attention.launches = 0
