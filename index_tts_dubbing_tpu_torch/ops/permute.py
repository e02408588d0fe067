"""Gen-cache permute kernels of the beam decode: copy-on-fork and the row
gather, over the split cache's generated region ``(L, BN, H, G, D)``.

Counterpart of the JAX package's ``ops/pallas_permute.py``, function for
function:

- ``copy_on_fork`` (Pallas ``copy_on_fork``, :182): in place, row ``r`` with
  ``cp[r] >= 0`` takes row ``cp[r]``'s gen slots in the G-blocks ``g`` with
  ``g·gb <= bound``; other rows are untouched. ``gb`` is the largest divisor
  of G that is <= 64 with ``gb·D % 128 == 0``; when there is none, the whole
  row is copied, whatever the bound (the Pallas wrapper's gather fallback).
- ``permute_gen_cache`` (:41) and ``permute_gen_cache_pipelined`` (:266):
  ``out[:, i] = in[:, src[i]]``.
- ``permute_gen_cache_burst`` (:87) and ``permute_gen_cache_bounded`` (:306):
  the same gather, with slot ``s`` zero unless its G-block of ``gb`` slots
  starts at or before ``bound`` (``(s // gb)·gb <= bound``).

Two CUDA kernels in ``csrc/permute.cu`` do the work: one in-place copy for
``copy_on_fork`` and one gather with an optional bound for the other four.
The bound is a host int and the row indices stay on the device, so no call
waits for the device. Each public function takes its ``*_plain`` twin only
for CPU tensors, launches its kernel for CUDA tensors, and counts its own
launches in ``<function>.launches``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from index_tts_dubbing_tpu_torch.ops import cuda_lib

Pair = Tuple[torch.Tensor, torch.Tensor]


def fork_block(g_len: int, d: int, gb: int = 64) -> int:
    """The Pallas ``copy_on_fork`` block: the largest divisor of ``g_len``
    that is <= ``gb`` with ``(block·d) % 128 == 0``, or 0 when none exists."""
    gb = min(gb, g_len)
    while gb > 0 and (g_len % gb != 0 or (gb * d) % 128 != 0):
        gb -= 1
    return gb


def live_slots(g_len: int, bound: int, gb: int) -> int:
    """Slots [0, n) of the G-blocks of ``gb`` slots that start at or before
    ``bound``: ``min(G, (bound // gb + 1)·gb)``, 0 for a negative bound."""
    return max(0, min(g_len, (bound // gb + 1) * gb))


def fork_slots(g_len: int, d: int, bound: int, gb: int = 64) -> int:
    """Slots that ``copy_on_fork`` copies for a forked row."""
    blk = fork_block(g_len, d, gb)
    return g_len if blk == 0 else live_slots(g_len, bound, blk)


def _gather_slots(g_len: int, bound: int, gb: int) -> int:
    """Slots that the bounded gather copies (the rest are zero)."""
    return live_slots(g_len, bound, min(gb, g_len))


# --------------------------------------------------------------------------
# plain versions


def copy_on_fork_plain(kg: torch.Tensor, vg: torch.Tensor, cp: torch.Tensor,
                       bound: int, gb: int = 64) -> Pair:
    """In place on kg/vg (L, BN, H, G, D); returns them."""
    n = fork_slots(kg.shape[3], kg.shape[4], int(bound), gb)
    rows = torch.arange(kg.shape[1], device=cp.device)
    idx = torch.where(cp >= 0, cp.long(), rows)
    for arr in (kg, vg):
        arr[:, :, :, :n] = arr[:, :, :, :n].index_select(1, idx)
    return kg, vg


def _gather_plain(kg: torch.Tensor, vg: torch.Tensor, src: torch.Tensor,
                  n: int) -> Pair:
    out = []
    for arr in (kg, vg):
        o = arr.index_select(1, src.long())
        o[:, :, :, n:] = 0
        out.append(o)
    return out[0], out[1]


def permute_gen_cache_plain(kg, vg, src_idx) -> Pair:
    return _gather_plain(kg, vg, src_idx, kg.shape[3])


def permute_gen_cache_burst_plain(kg, vg, src_idx, bound: int,
                                  gb: int = 64) -> Pair:
    return _gather_plain(kg, vg, src_idx,
                         _gather_slots(kg.shape[3], int(bound), gb))


# the pipelined and bounded Pallas kernels compute the same functions
permute_gen_cache_pipelined_plain = permute_gen_cache_plain
permute_gen_cache_bounded_plain = permute_gen_cache_burst_plain


# --------------------------------------------------------------------------
# kernels


def _check(kg: torch.Tensor, vg: torch.Tensor, idx: torch.Tensor,
           name: str) -> None:
    if kg.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {kg.device}")
    if kg.dim() != 5 or 0 in kg.shape:
        raise ValueError(f"{name}: kg must be a non-empty (L, BN, H, G, D), "
                         f"got {tuple(kg.shape)}")
    cuda_lib.require(kg, "kg", kg.device)
    cuda_lib.require(vg, "vg", kg.device, kg.dtype, kg.shape)
    cuda_lib.require(idx, "row index", kg.device, torch.int32,
                     (kg.shape[1],))


def copy_on_fork(kg: torch.Tensor, vg: torch.Tensor, cp: torch.Tensor,
                 bound: int, gb: int = 64) -> Pair:
    """Copy-on-fork update of the gen caches, in place; returns (kg, vg).

    kg/vg (L, BN, H, G, D), cp (BN,) int32 (source row, or < 0 to keep the
    row), ``bound`` the highest written gen slot (a host int). The caller
    guarantees that sources and destinations are disjoint (the beam decode's
    kept and freed rows), so the copy has no hazard; checking it would wait
    for the device."""
    if kg.device.type == "cpu":
        return copy_on_fork_plain(kg, vg, cp, bound, gb)
    _check(kg, vg, cp, "copy_on_fork")
    l, bn, h, g_len, d = kg.shape
    n = fork_slots(g_len, d, int(bound), gb)
    rc = cuda_lib.load().copy_on_fork(
        kg.data_ptr(), vg.data_ptr(), cp.data_ptr(), l, bn, h, g_len * d,
        n * d, kg.element_size(), cuda_lib.stream_ptr(kg.device))
    cuda_lib.check(rc, "copy_on_fork")
    copy_on_fork.launches += 1
    return kg, vg


def _gather(kg: torch.Tensor, vg: torch.Tensor, src: torch.Tensor, n: int,
            name: str) -> Pair:
    _check(kg, vg, src, name)
    l, bn, h, g_len, d = kg.shape
    k2, v2 = torch.empty_like(kg), torch.empty_like(vg)
    rc = cuda_lib.load().permute_gen_cache(
        kg.data_ptr(), vg.data_ptr(), k2.data_ptr(), v2.data_ptr(),
        src.data_ptr(), l, bn, h, g_len * d, n * d, kg.element_size(),
        cuda_lib.stream_ptr(kg.device))
    cuda_lib.check(rc, name)
    return k2, v2


def permute_gen_cache(kg: torch.Tensor, vg: torch.Tensor,
                      src_idx: torch.Tensor) -> Pair:
    """(kg', vg') with ``out[:, i] = in[:, src_idx[i]]``; src_idx (BN,) int32."""
    if kg.device.type == "cpu":
        return permute_gen_cache_plain(kg, vg, src_idx)
    out = _gather(kg, vg, src_idx, kg.shape[3], "permute_gen_cache")
    permute_gen_cache.launches += 1
    return out


def permute_gen_cache_pipelined(kg: torch.Tensor, vg: torch.Tensor,
                                src_idx: torch.Tensor) -> Pair:
    """``permute_gen_cache`` (the Pallas version ran it through a BlockSpec
    pipeline; on the card it is the same gather)."""
    if kg.device.type == "cpu":
        return permute_gen_cache_pipelined_plain(kg, vg, src_idx)
    out = _gather(kg, vg, src_idx, kg.shape[3], "permute_gen_cache_pipelined")
    permute_gen_cache_pipelined.launches += 1
    return out


def permute_gen_cache_burst(kg: torch.Tensor, vg: torch.Tensor,
                            src_idx: torch.Tensor, bound: int,
                            gb: int = 64) -> Pair:
    """The gather with G-blocks of ``gb`` slots past ``bound`` zero-filled
    (the last block may be ragged: only slots < G exist)."""
    if kg.device.type == "cpu":
        return permute_gen_cache_burst_plain(kg, vg, src_idx, bound, gb)
    out = _gather(kg, vg, src_idx, _gather_slots(kg.shape[3], int(bound), gb),
                  "permute_gen_cache_burst")
    permute_gen_cache_burst.launches += 1
    return out


def permute_gen_cache_bounded(kg: torch.Tensor, vg: torch.Tensor,
                              src_idx: torch.Tensor, bound: int,
                              gb: int = 64) -> Pair:
    """``permute_gen_cache_burst`` (the Pallas version issued one DMA per
    layer, row and block; on the card it is the same gather)."""
    if kg.device.type == "cpu":
        return permute_gen_cache_bounded_plain(kg, vg, src_idx, bound, gb)
    out = _gather(kg, vg, src_idx, _gather_slots(kg.shape[3], int(bound), gb),
                  "permute_gen_cache_bounded")
    permute_gen_cache_bounded.launches += 1
    return out


GATHERS = (permute_gen_cache, permute_gen_cache_burst,
           permute_gen_cache_pipelined, permute_gen_cache_bounded)
for _fn in (copy_on_fork,) + GATHERS:
    _fn.launches = 0
