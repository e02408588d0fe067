"""Continuous batching over the AR decoder: fixed B decode slots, rows are
refilled from a device-resident request queue the moment they finish.

Counterpart of the JAX package's ``engine/continuous.py``. A finished row's
slot is re-used by the next pending request on the next step, so
heterogeneous sentence lengths do not wait for the longest row of a bucket.

Design:
- ``prefill``: the trunk over a batch of prefixes at one bucketed width;
  every request of a wave is prefilled up front in power-of-two groups and
  parked in a device-resident queue (``CBQueue``: per-request K/V block,
  first token, seen set);
- ``cb_run``: every step decodes all B slots (per-row positions and done
  flags); then, on the device and for every slot at once, finished rows
  flush their tokens to the per-request result buffer and are refilled
  from the queue by masked writes (``torch.where`` on the finished slots,
  the next request = ``next_req`` + a cumsum of the finished mask). No step
  reads anything back to the host; the host checks "no live row and no
  pending request" every 8 steps, as ``decode.generate`` checks "every row
  done", so up to 7 trailing steps run with no live row and change nothing.
  JAX runs the same loop inside one ``while_loop`` and gates the refill's
  writes with ``lax.cond``; here they run every step, masked.
- ``insert`` / ``decode_chunk``: host-driven primitives (install one
  prefilled request into a slot; run up to ``steps`` steps).

JAX parks finished dummy slots on the out-of-range result row ``n_req`` and
relies on XLA dropping out-of-range scatters and clamping out-of-range
gathers; PyTorch raises on both, so the result buffers here carry one sink
row at index ``n_req``, and every gather index is made valid explicitly.

Sampling semantics are those of engine/decode.py (HF processor order,
repetition penalty over the seen-token set, the tortoise mel-position
off-by-one), so a row decoded here matches ``generate`` row for row (greedy:
exactly; sampling draws from the caller's generator per row).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.config import GPTConfig
from index_tts_dubbing_tpu_torch.engine import decode as decode_mod
from index_tts_dubbing_tpu_torch.engine.decode import SamplingConfig
from index_tts_dubbing_tpu_torch.models import gpt as gpt_model
from index_tts_dubbing_tpu_torch.models.gpt import KVCache

Params = Dict[str, Any]
_NEG = -1e30
# decode steps between host checks of "no live row and no pending request"
_DONE_CHECK_EVERY = decode_mod._DONE_CHECK_EVERY


@dataclass
class CBState:
    """Decode slots. Updated in place by ``_step``, ``insert`` and
    ``cb_run``."""
    cache: KVCache             # (L, B, H, S, D)
    key_keep: torch.Tensor     # (B, S) bool: cache slots attention may see
    pos: torch.Tensor          # (B,) long: next cache slot to write
    n_gen: torch.Tensor        # (B,) long: tokens generated so far
    prev: torch.Tensor         # (B,) long: last sampled token
    done: torch.Tensor         # (B,) bool
    active: torch.Tensor       # (B,) bool: slot holds a live request
    seen: torch.Tensor         # (B, V) bool: repetition-penalty set
    tokens: torch.Tensor       # (B, max_steps) long
    row_max: torch.Tensor      # (B,) long: per-request generation cap


def init_state(cfg: GPTConfig, sc: SamplingConfig, batch: int, s_total: int,
               dtype, device) -> CBState:
    b = batch
    long = dict(dtype=torch.long, device=device)
    return CBState(
        cache=gpt_model.init_cache(cfg, b, s_total, dtype, device),
        key_keep=torch.zeros((b, s_total), dtype=torch.bool, device=device),
        pos=torch.zeros(b, **long),
        n_gen=torch.zeros(b, **long),
        prev=torch.full((b,), cfg.stop_mel_token, **long),
        done=torch.ones(b, dtype=torch.bool, device=device),
        active=torch.zeros(b, dtype=torch.bool, device=device),
        seen=torch.zeros((b, cfg.number_mel_codes), dtype=torch.bool,
                         device=device),
        tokens=torch.full((b, sc.max_mel_tokens), cfg.stop_mel_token, **long),
        row_max=torch.full((b,), sc.max_mel_tokens, **long),
    )


def prefill(params: Params, cfg: GPTConfig, emb: torch.Tensor,
            pad_keep: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
    """Batched prefix forward at bucket width S0: (h_last (B, C), kv
    (L, B, H, S0, D))."""
    b, s0 = emb.shape[:2]
    cache = gpt_model.init_cache(cfg, b, s0, emb.dtype, emb.device)
    h = gpt_model.trunk_prefill(params, cfg, emb, pad_keep, cache)
    return h, cache


def _sample(logits: torch.Tensor, sc: SamplingConfig,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """One token per row from processed logits (B, V)."""
    if sc.do_sample:
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def _first_seen(cfg: GPTConfig, sc: SamplingConfig, n: int,
                device) -> torch.Tensor:
    """The seen-set before the first token: the fake prefix id and the
    start token, as ``generate`` starts it."""
    seen = torch.zeros((n, cfg.number_mel_codes), dtype=torch.bool,
                       device=device)
    seen[:, sc.fake_prefix_id] = True
    seen[:, cfg.start_mel_token] = True
    return seen


def insert(params: Params, cfg: GPTConfig, sc: SamplingConfig, st: CBState,
           row: int, h_last: torch.Tensor, kv: KVCache,
           pad_keep: torch.Tensor, max_new: Optional[int] = None,
           generator: Optional[torch.Generator] = None) -> CBState:
    """Install a prefilled request into slot ``row`` and sample its first
    token. ``h_last`` (1, C), ``kv`` (L, 1, H, S0, D), ``pad_keep`` (1, S0)
    marks real (non-pad) prefix slots."""
    s0 = kv.k.shape[3]
    st.cache.k[:, row, :, :s0] = kv.k[:, 0].to(st.cache.k.dtype)
    st.cache.v[:, row, :, :s0] = kv.v[:, 0].to(st.cache.v.dtype)
    st.key_keep[row] = False
    st.key_keep[row, :s0] = pad_keep[0]
    seen = _first_seen(cfg, sc, 1, h_last.device)
    logits = decode_mod._process_logits(
        gpt_model.mel_logits_from_hidden(params, h_last), seen, sc)
    tok0 = _sample(logits, sc, generator)
    seen[0, tok0[0]] = True
    st.tokens[row] = cfg.stop_mel_token
    st.tokens[row, 0] = tok0[0]
    st.pos[row] = s0
    st.n_gen[row] = 1
    st.prev[row] = tok0[0]
    st.done[row] = tok0[0] == cfg.stop_mel_token
    st.active[row] = True
    st.seen[row] = seen[0]
    st.row_max[row] = sc.max_mel_tokens if max_new is None else max_new
    return st


def _step(params: Params, cfg: GPTConfig, sc: SamplingConfig, st: CBState,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """One decode step over all B slots with per-row positions, in place.
    Returns the live mask the step ran with."""
    b, s_total = st.key_keep.shape
    rows = torch.arange(b, device=st.pos.device)
    live = st.active & ~st.done
    # embed the previous token; generated token n (1-based) sits at mel
    # position n+1
    mel_pos = params["mel_pos"]["w"]
    x = (params["mel_emb"]["w"][st.prev]
         + mel_pos[torch.clamp(st.n_gen + 1, 0, mel_pos.shape[0] - 1)]
         ).to(st.cache.k.dtype)
    pos = torch.clamp(st.pos, 0, s_total - 1)
    # this step's slot becomes visible for live rows
    st.key_keep[rows, pos] = st.key_keep[rows, pos] | live
    kbias = torch.where(st.key_keep, 0.0, _NEG).float()[:, None, None, :]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    x = x[:, None, :]
    for li, blk in enumerate(params["blocks"]):
        q, k, v = gpt_model._qkv(cfg, blk, x)          # (B, H, 1, D)
        st.cache.k[li, rows, :, pos] = k[:, :, 0].to(st.cache.k.dtype)
        st.cache.v[li, rows, :, pos] = v[:, :, 0].to(st.cache.v.dtype)
        o = gpt_model._attend(q, st.cache.k[li].to(q.dtype),
                              st.cache.v[li].to(x.dtype), kbias, scale)
        x = gpt_model._block_out(cfg, blk, x, o)
    h = nn.layer_norm(params["ln_f"], x[:, 0, :])

    logits = decode_mod._process_logits(
        gpt_model.mel_logits_from_hidden(params, h), st.seen, sc)
    stop = cfg.stop_mel_token
    tok = torch.where(live, _sample(logits, sc, generator), stop)
    write = torch.clamp(st.n_gen, 0, st.tokens.shape[1] - 1)
    st.tokens[rows, write] = torch.where(live, tok, st.tokens[rows, write])
    st.seen[rows, tok] = st.seen[rows, tok] | live
    hit_cap = st.n_gen + 1 >= torch.clamp(st.row_max, max=sc.max_mel_tokens)
    st.done |= live & ((tok == stop) | hit_cap)
    st.pos = torch.where(live, pos + 1, st.pos)
    st.n_gen = torch.where(live, st.n_gen + 1, st.n_gen)
    st.prev = torch.where(live, tok, st.prev)
    return live


def decode_chunk(params: Params, cfg: GPTConfig, sc: SamplingConfig,
                 st: CBState, steps: int,
                 generator: Optional[torch.Generator] = None) -> CBState:
    """Up to ``steps`` decode steps, stopping once no slot is live (checked
    on the host every 8 steps)."""
    for i in range(steps):
        if i % _DONE_CHECK_EVERY == 0 and not bool((st.active
                                                     & ~st.done).any()):
            break
        _step(params, cfg, sc, st, generator)
    return st


class CBQueue(NamedTuple):
    """Device-resident prefilled request queue (all rows padded to one
    prefix width S0max; per-request real width in ``pos``)."""
    kv_k: torch.Tensor      # (L, N, H, S0max, D)
    kv_v: torch.Tensor
    keep: torch.Tensor      # (N, S0max) bool: real prefix slots
    tok0: torch.Tensor      # (N,) long: first sampled token
    seen0: torch.Tensor     # (N, V) bool: rep-penalty set incl. tok0
    pos: torch.Tensor       # (N,) long: next cache slot (= real s0)
    max_new: torch.Tensor   # (N,) long: per-request cap


def queue_first_tokens(params: Params, cfg: GPTConfig, sc: SamplingConfig,
                       h: torch.Tensor,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every queued request's first token in one batched call:
    h (N, C) → (tok0 (N,), seen0 (N, V))."""
    n = h.shape[0]
    seen = _first_seen(cfg, sc, n, h.device)
    logits = decode_mod._process_logits(
        gpt_model.mel_logits_from_hidden(params, h), seen, sc)
    tok0 = _sample(logits, sc, generator)
    seen[torch.arange(n, device=h.device), tok0] = True
    return tok0, seen


class CBRun(NamedTuple):
    tokens: torch.Tensor     # (N, max_steps) long, stop-padded
    n_gen: torch.Tensor      # (N,) long
    steps: int               # decode steps run
    installs: torch.Tensor   # 0-d: requests installed into a slot
    live_rows: torch.Tensor  # 0-d: live (slot, step) pairs decoded


def _flush_and_refill(cfg: GPTConfig, st: CBState, queue: CBQueue,
                      slot_req: torch.Tensor, next_req: torch.Tensor,
                      out_tokens: torch.Tensor, out_ngen: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Finished rows flush their tokens to their request's result row (the
    sink row ``n_req`` for every other row) and take the next queued
    requests, in row order, by masked writes on the device. Returns
    (slot_req, next_req, the number of requests installed), all on the
    device."""
    n_req = queue.tok0.shape[0]
    s0max = queue.keep.shape[1]
    fin = st.active & st.done
    dst = torch.where(fin, slot_req, n_req)
    out_tokens[dst] = st.tokens
    out_ngen[dst] = st.n_gen
    req_for_row = next_req + torch.cumsum(fin, 0) - 1   # rank among fin
    refill = fin & (req_for_row < n_req)
    req_idx = torch.where(refill, req_for_row, 0)
    sel = refill[None, :, None, None, None]
    for cache, src in ((st.cache.k, queue.kv_k), (st.cache.v, queue.kv_v)):
        cache[:, :, :, :s0max] = torch.where(
            sel, src[:, req_idx].to(cache.dtype), cache[:, :, :, :s0max])
    keep_new = torch.zeros_like(st.key_keep)
    keep_new[:, :s0max] = queue.keep[req_idx]
    st.key_keep = torch.where(refill[:, None], keep_new, st.key_keep)
    tok0 = queue.tok0[req_idx]
    tokens_new = torch.full_like(st.tokens, cfg.stop_mel_token)
    tokens_new[:, 0] = tok0
    st.tokens = torch.where(refill[:, None], tokens_new, st.tokens)
    st.pos = torch.where(refill, queue.pos[req_idx], st.pos)
    st.n_gen = torch.where(refill, 1, st.n_gen)
    st.prev = torch.where(refill, tok0, st.prev)
    st.done = torch.where(refill, tok0 == cfg.stop_mel_token, st.done)
    st.active = torch.where(fin, refill, st.active)
    st.seen = torch.where(refill[:, None], queue.seen0[req_idx], st.seen)
    st.row_max = torch.where(refill, queue.max_new[req_idx], st.row_max)
    n_refill = refill.sum()
    return (torch.where(refill, req_idx, slot_req), next_req + n_refill,
            n_refill)


def cb_run(params: Params, cfg: GPTConfig, sc: SamplingConfig, st: CBState,
           queue: CBQueue, slot_req: torch.Tensor, next_req: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> CBRun:
    """The whole workload: decode all B slots each step; finished rows flush
    their tokens to the per-request result buffer and refill from the queue
    on the device after every step. The host reads one flag every 8 steps."""
    b = st.active.shape[0]
    n_req = queue.tok0.shape[0]
    dev = st.pos.device
    # one sink row (index n_req) takes the flushes of unfinished rows
    out_tokens = torch.full((n_req + 1, sc.max_mel_tokens), cfg.stop_mel_token,
                            dtype=torch.long, device=dev)
    out_ngen = torch.zeros(n_req + 1, dtype=torch.long, device=dev)
    live_rows = torch.zeros((), dtype=torch.long, device=dev)
    # rows may already be done right after install (stop as first token)
    slot_req, next_req, installs = _flush_and_refill(
        cfg, st, queue, slot_req, next_req, out_tokens, out_ngen)
    steps = 0
    while True:
        if steps % _DONE_CHECK_EVERY == 0 and not bool(
                (st.active & ~st.done).any() | (next_req < n_req)):
            break
        live_rows += _step(params, cfg, sc, st, generator).sum()
        slot_req, next_req, n = _flush_and_refill(
            cfg, st, queue, slot_req, next_req, out_tokens, out_ngen)
        installs += n
        steps += 1
    return CBRun(out_tokens[:n_req], out_ngen[:n_req], steps, installs,
                 live_rows)


@dataclass
class CBRequest:
    uid: int
    text_ids: np.ndarray
    # optional per-request generation cap (duration-targeted dubbing); None
    # → sc.max_mel_tokens
    max_new: Optional[int] = None


class ContinuousBatcher:
    """Host orchestrator: feeds a request queue through B decode slots.

    ``run`` returns {uid: (codes (n,), length)} with the same token semantics
    as engine.decode.generate. Conditioning latents are shared across
    requests (one speaker prompt per batch run, like the reference engine).
    After ``run``, ``stats`` holds the decode steps, the installs (requests
    put into a slot; those past the first B are refills) and the mean slot
    occupancy (live slot-steps over B × steps), summed over the waves.
    """

    def __init__(self, params: Params, cfg: GPTConfig, sc: SamplingConfig,
                 conds: torch.Tensor, batch: int = 8,
                 text_buckets: Sequence[int] = (16, 32, 48, 64, 80, 96, 120),
                 generator: Optional[torch.Generator] = None):
        self.params = params
        self.cfg = cfg
        self.sc = sc
        self.conds = conds
        self.batch = batch
        self.text_buckets = tuple(text_buckets)
        self.generator = generator
        self.stats: Dict[str, float] = {}

    def _bucket(self, n: int) -> int:
        return next((b for b in self.text_buckets if b >= n), n)

    def run(self, requests: Sequence[CBRequest], dtype=torch.float32,
            max_queue: int = 64) -> Dict[int, Tuple[np.ndarray, int]]:
        """Synthesize every request; returns {uid: (codes, length)}.

        All requests (per wave of ≤ max_queue, bounding the queue's device
        memory) are prefilled up front in power-of-two batched calls, parked
        in a CBQueue, and decoded by one ``cb_run``, which refills slots on
        the device."""
        results: Dict[int, Tuple[np.ndarray, int]] = {}
        self.stats = {"waves": 0, "steps": 0, "installs": 0, "live_rows": 0,
                      "slot_steps": 0}
        reqs = list(requests)
        for w0 in range(0, len(reqs), max_queue):
            results.update(self._run_wave(reqs[w0:w0 + max_queue], dtype))
        st = self.stats
        st["refills"] = st["installs"] - min(self.batch, len(reqs)) * st["waves"]
        st["occupancy"] = st["live_rows"] / max(st["slot_steps"], 1)
        return results

    def _run_wave(self, reqs: List[CBRequest], dtype
                  ) -> Dict[int, Tuple[np.ndarray, int]]:
        cfg, sc = self.cfg, self.sc
        n_req = len(reqs)
        if n_req == 0:
            return {}
        dev = self.conds.device
        pad_to = max(self._bucket(r.text_ids.size) for r in reqs)
        # prefill in power-of-two groups at one common width (pads are
        # attention-masked; one width keeps the queue a single tensor)
        ks, vs, keeps, hs = [], [], [], []
        i0 = 0
        while i0 < n_req:
            g = 1 << ((n_req - i0).bit_length() - 1)
            group = reqs[i0:i0 + g]
            i0 += g
            pre = decode_mod.prepare_prefix_host(
                cfg, [r.text_ids for r in group], pad_to=pad_to)
            t = lambda k: torch.as_tensor(pre[k].astype(np.int64), device=dev)
            emb, keep = decode_mod.build_prefix_emb(
                self.params, cfg, self.conds, t("ids"), t("pos"), t("seg"),
                t("cond_idx"))
            h, kv = prefill(self.params, cfg, emb.to(dtype), keep)
            ks.append(kv.k)
            vs.append(kv.v)
            keeps.append(keep)
            hs.append(h)
        keep = torch.cat(keeps)
        s0 = keep.shape[1]
        tok0, seen0 = queue_first_tokens(self.params, cfg, sc, torch.cat(hs),
                                         self.generator)
        queue = CBQueue(
            kv_k=torch.cat(ks, dim=1), kv_v=torch.cat(vs, dim=1), keep=keep,
            tok0=tok0, seen0=seen0,
            pos=torch.full((n_req,), s0, dtype=torch.long, device=dev),
            max_new=torch.as_tensor(
                [min(r.max_new or sc.max_mel_tokens, sc.max_mel_tokens)
                 for r in reqs], dtype=torch.long, device=dev))
        b = self.batch
        state = init_state(cfg, sc, b, s0 + sc.max_mel_tokens, dtype, dev)
        # every slot starts as a finished dummy flushing to the sink row;
        # cb_run's first flush installs the first B requests
        state.active[:] = True
        slot_req = torch.full((b,), n_req, dtype=torch.long, device=dev)
        res = cb_run(self.params, cfg, sc, state, queue, slot_req,
                     torch.zeros((), dtype=torch.long, device=dev),
                     self.generator)
        out_tokens = res.tokens.cpu().numpy()
        out_ngen = res.n_gen.cpu().numpy()
        self.stats["waves"] += 1
        self.stats["steps"] += res.steps
        self.stats["installs"] += int(res.installs)
        self.stats["live_rows"] += int(res.live_rows)
        self.stats["slot_steps"] += b * res.steps
        results: Dict[int, Tuple[np.ndarray, int]] = {}
        for i, r in enumerate(reqs):
            row = out_tokens[i]
            stops = np.nonzero(row == cfg.stop_mel_token)[0]
            ln = int(stops[0]) if stops.size else int(out_ngen[i])
            results[r.uid] = (row.copy(), ln)
        return results
