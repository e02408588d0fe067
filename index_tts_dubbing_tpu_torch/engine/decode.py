"""Autoregressive mel-code decoding (sampling and greedy): prefill, then one
decode step per token over a KV cache allocated once.

Counterpart of the JAX package's ``engine/decode.py``: sampling and greedy
decode (``generate``), and beam search / beam sampling (``_beam_decode``,
below ``generate``). Semantics kept from the reference:

- left-padded [pad][cond(32)][start, text, stop] prefix with per-row text
  positions restarting at 0;
- decode starts from the start_mel token appended to the prefix;
- generated token j (1-based) takes mel position j+1 (tortoise off-by-one);
- HF sampling order: repetition penalty over all previously seen ids
  (including the all-ones fake prefix ids and the start token, so ids 1 and
  8192 are penalised from step 0) → typical → temperature → top-k → top-p;
- each row stops at stop_mel_token; finished rows emit stop_mel.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.config import GPTConfig
from index_tts_dubbing_tpu_torch.models import gpt as gpt_model
from index_tts_dubbing_tpu_torch.ops import permute

SEG_PAD, SEG_COND, SEG_TEXT = 0, 1, 2
# decode steps between host checks of "every row finished": the check syncs
# with the device, and steps after the last stop only emit stop tokens
_DONE_CHECK_EVERY = 8


@dataclass(frozen=True)
class SamplingConfig:
    do_sample: bool = True
    temperature: float = 1.0
    top_k: int = 30
    top_p: float = 0.8
    repetition_penalty: float = 10.0
    max_mel_tokens: int = 600
    # locally-typical sampling, between the repetition penalty and the
    # temperature/top-k/top-p warpers (HF processor order)
    typical_sampling: bool = False
    typical_mass: float = 0.9
    # HF fake-prefix ids seen by the repetition penalty (all-ones input_ids)
    fake_prefix_id: int = 1


def prepare_prefix_host(cfg: GPTConfig, texts: Sequence[np.ndarray],
                        pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Host-side prefix layout: each row stripped of start/stop tokens,
    re-framed as [start, text, stop] and left-padded to the common width.
    Returns ids/pos/seg/cond_idx arrays of shape (B, 32+L+2)."""
    cond_n = cfg.condition_num_latent
    rows = []
    l_raw = max(np.asarray(t).reshape(-1).size for t in texts)
    for t in texts:
        t = np.asarray(t).reshape(-1)
        t = t[(t != cfg.start_text_token) & (t != cfg.stop_text_token)]
        rows.append(np.concatenate([[cfg.start_text_token], t,
                                    [cfg.stop_text_token]]).astype(np.int32))
    # the reference pads every row to the unstripped common width + 2;
    # ``pad_to`` widens to a bucket (extra left-padding is masked)
    if pad_to is not None:
        l_raw = max(l_raw, pad_to)
    lmax = l_raw + 2
    b = len(rows)
    target = cond_n + lmax
    ids = np.zeros((b, target), np.int32)
    pos = np.zeros((b, target), np.int32)
    seg = np.full((b, target), SEG_PAD, np.int32)
    cond_idx = np.zeros((b, target), np.int32)
    for i, r in enumerate(rows):
        pad = lmax - r.size
        seg[i, pad:pad + cond_n] = SEG_COND
        cond_idx[i, pad:pad + cond_n] = np.arange(cond_n)
        seg[i, pad + cond_n:] = SEG_TEXT
        ids[i, pad + cond_n:] = r
        pos[i, pad + cond_n:] = np.arange(r.size)
    return {"ids": ids, "pos": pos, "seg": seg, "cond_idx": cond_idx}


def build_prefix_emb(params: Dict[str, Any], cfg: GPTConfig,
                     conds: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
                     seg: torch.Tensor, cond_idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefix embedding + the trailing start_mel slot: (emb (B, S0, C) in the
    parameters' dtype, pad_keep (B, S0))."""
    b = ids.shape[0]
    dtype = params["mel_emb"]["w"].dtype
    if conds.shape[0] == 1 and b > 1:
        conds = conds.expand((b,) + conds.shape[1:])
    text_e = nn.embedding(params["text_emb"], ids) + params["text_pos"]["w"][pos]
    cond_e = torch.gather(conds, 1, cond_idx[..., None].expand(
        -1, -1, conds.shape[-1]))
    zero = torch.zeros((), dtype=text_e.dtype, device=text_e.device)
    emb = torch.where((seg == SEG_TEXT)[..., None], text_e, zero)
    emb = torch.where((seg == SEG_COND)[..., None], cond_e.to(dtype), emb)
    start = (params["mel_emb"]["w"][cfg.start_mel_token]
             + params["mel_pos"]["w"][0])
    emb = torch.cat([emb, start[None, None].expand(b, 1, emb.shape[-1])], dim=1)
    pad_keep = torch.cat([seg != SEG_PAD,
                          torch.ones((b, 1), dtype=torch.bool, device=seg.device)],
                         dim=1)
    return emb.to(dtype), pad_keep


def _typical_filter(logits: torch.Tensor, mass: float,
                    min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Locally-typical filtering: keep the tokens whose |surprisal − entropy|
    is smallest, up to cumulative probability ``mass``."""
    logp = torch.log_softmax(logits, dim=-1)
    p = logp.exp()
    ent = -torch.where(p > 0, logp * p, torch.zeros_like(p)).sum(-1, keepdim=True)
    shifted = (-logp - ent).abs()
    order = torch.argsort(shifted, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, order)
    sorted_shifted = torch.gather(shifted, -1, order)
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(-1)
    last_ind = torch.clamp((cum < mass).sum(-1), min=0)
    cutoff = torch.gather(sorted_shifted, -1, last_ind[..., None])
    remove = shifted > cutoff
    if min_tokens_to_keep > 1:
        keep_cut = sorted_shifted[..., min_tokens_to_keep - 1: min_tokens_to_keep]
        remove = remove & (shifted > keep_cut)
    return logits.masked_fill(remove, float("-inf"))


def _process_logits(logits: torch.Tensor, seen: torch.Tensor,
                    sc: SamplingConfig) -> torch.Tensor:
    """HF-order logits pipeline in float32. logits (B, V), seen (B, V) bool."""
    logits = logits.float()
    if sc.repetition_penalty != 1.0:
        pen = torch.where(logits > 0, logits / sc.repetition_penalty,
                          logits * sc.repetition_penalty)
        logits = torch.where(seen, pen, logits)
    if sc.typical_sampling:
        logits = _typical_filter(logits, sc.typical_mass)
    if not sc.do_sample:
        return logits
    if sc.temperature != 1.0:
        logits = logits / sc.temperature
    v = logits.shape[-1]
    k = min(sc.top_k, v) if sc.top_k > 0 else v
    if sc.top_k > 0 and k < v:
        topv = torch.topk(logits, k, dim=-1).values
        logits = logits.masked_fill(logits < topv[..., -1:], float("-inf"))
    else:
        topv = torch.sort(logits, dim=-1, descending=True).values
    if sc.top_p < 1.0:
        # top-p over the sorted top-k slice: the smallest kept value is the
        # cutoff (the first token is always kept)
        probs = torch.softmax(topv, dim=-1)
        cum = probs.cumsum(-1)
        kth = ((cum - probs) <= sc.top_p).sum(-1) - 1
        cutoff = torch.gather(topv, -1, kth[..., None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


class GenerateResult(NamedTuple):
    codes: torch.Tensor     # (B, max_steps) generated mel codes, stop-padded
    lengths: torch.Tensor   # (B,) codes before the stop token
    steps: int              # decode iterations executed


def generate(params: Dict[str, Any], cfg: GPTConfig, sc: SamplingConfig,
             prefix_emb: torch.Tensor, pad_keep: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             live: Optional[torch.Tensor] = None) -> GenerateResult:
    """Sample (or, with ``do_sample=False``, greedily pick) mel codes.
    prefix_emb (B, S0, C) ends with the start_mel slot. ``live`` (B,) bool
    marks batch-padding rows False: they emit stop at step 0 and never keep
    the loop running. The loop runs at most ``sc.max_mel_tokens`` steps."""
    b, s0, _ = prefix_emb.shape
    dev = prefix_emb.device
    max_steps = sc.max_mel_tokens
    s_total = s0 + max_steps
    cache = gpt_model.init_cache(cfg, b, s_total, prefix_emb.dtype, dev)
    h = gpt_model.trunk_prefill(params, cfg, prefix_emb, pad_keep, cache)
    # slot validity: prefix pads stay masked, generated slots open as the
    # loop advances
    keep = torch.cat([pad_keep, torch.zeros((b, max_steps), dtype=torch.bool,
                                            device=dev)], dim=1)
    rows = torch.arange(b, device=dev)
    seen = torch.zeros((b, cfg.number_mel_codes), dtype=torch.bool, device=dev)
    seen[:, sc.fake_prefix_id] = True
    seen[:, cfg.start_mel_token] = True
    stop = torch.full((), cfg.stop_mel_token, dtype=torch.long, device=dev)

    def sample_token(hidden):
        logits = _process_logits(
            gpt_model.mel_logits_from_hidden(params, hidden), seen, sc)
        if sc.do_sample:
            probs = torch.softmax(logits, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.argmax(logits, dim=-1)

    tok = sample_token(h)
    if live is not None:
        tok = torch.where(live, tok, stop)
    done = tok == stop
    tokens = torch.full((b, max_steps), cfg.stop_mel_token, dtype=torch.long,
                        device=dev)
    tokens[:, 0] = tok
    seen[rows, tok] = True
    j = 1
    while j < max_steps:
        if j % _DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        # previous token at mel position j+1 (parity quirk)
        emb = (params["mel_emb"]["w"][tok]
               + params["mel_pos"]["w"][j + 1]).to(prefix_emb.dtype)
        slot = s0 + j - 1
        keep[:, slot] = True
        hh = gpt_model.trunk_decode_step(params, cfg, emb, cache, slot, keep)
        tok = torch.where(done, stop, sample_token(hh))
        done = done | (tok == stop)
        tokens[:, j] = tok
        seen[rows, tok] = True
        j += 1
    is_stop = tokens == cfg.stop_mel_token
    first_stop = torch.argmax(is_stop.int(), dim=1)
    lengths = torch.where(is_stop.any(dim=1), first_stop,
                          torch.full_like(first_stop, max_steps))
    return GenerateResult(tokens, lengths, j)


# ---------------------------------------------------------------------------
# Beam search / beam sampling (transformers-4.36 semantics)
# ---------------------------------------------------------------------------
#
# The reference decodes with HF ``generate`` at num_beams=3: with
# do_sample=True that is beam sampling, with do_sample=False beam search.
# One machinery serves both, as in the JAX package:
#
#   per-beam log-softmax → repetition penalty [→ typical] + beam scores
#   [→ warpers temperature → top-k → top-p with min_keep=2, beam sampling
#   only] → 2·nb candidates over the flat (nb·V) scores (beam sampling:
#   Gumbel top-k, i.e. multinomial without replacement; beam search: top-k)
#   → sorted by score → eos candidates ranked < nb join the finished pool
#   (best nb by score / generated_len**length_penalty, the eos counted);
#   the first nb non-eos candidates become the beams; finished rows emit
#   stop at score 0 → a row is done when its pool is full and its worst
#   pooled score beats the best attainable one → finalize: open beams join
#   the pool at generated_len = max_steps; the best hypothesis per row wins.
#
# Step 0 runs on the prefill's hidden state. Beam search masks beams 1..
# with -1e9 so that the nb copies do not repeat; beam sampling keeps all
# scores at zero (HF samples over nb identical copies, a quirk kept).
#
# History reorder (``reorder``): the prefix is stored once per batch row
# (gpt.SplitCache) and only the generated region is per beam.
#   "anc" (default): no cache row ever moves. A per-slot ancestry map
#         (B, nb, G) routes attention to the physical beam that holds each
#         slot (gpt.trunk_decode_step_split_anc).
#   "cof": copy-on-fork. Beams that survive keep their physical rows; each
#         forked beam copies its ancestor's history into a row that a dead
#         beam freed (ops/permute.copy_on_fork, one launch per step). The
#         trunk runs in physical row order (gpt.trunk_decode_step_split).
# Both give the same tokens as a full history gather.

_BEAM_NEG = -1e9
BEAM_REORDERS = ("anc", "cof")


def _gumbel(shape, generator: Optional[torch.Generator], device
            ) -> torch.Tensor:
    """Standard Gumbel noise in float32, ``-log(-log(u))`` with u kept away
    from 0. Beam sampling draws all its noise here."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis, equal values in index order (as
    ``jax.lax.top_k`` breaks ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _warp_scores(scores: torch.Tensor, sc: SamplingConfig,
                 min_tokens_to_keep: int = 2) -> torch.Tensor:
    """HF warper chain on the combined scores (logp + beam scores):
    temperature → top-k → top-p, each keeping at least
    ``min_tokens_to_keep`` tokens. As in transformers-4.36 beam_sample the
    warpers run after the beam scores are added, temperature included."""
    if sc.temperature != 1.0:
        scores = scores / sc.temperature
    v = scores.shape[-1]
    k = min(max(sc.top_k, min_tokens_to_keep), v) if sc.top_k > 0 else v
    if sc.top_k > 0 and k < v:
        topv = torch.topk(scores, k, dim=-1).values
        scores = scores.masked_fill(scores < topv[..., -1:], float("-inf"))
    else:
        topv = torch.sort(scores, dim=-1, descending=True).values
    if sc.top_p < 1.0:
        probs = torch.softmax(topv, dim=-1)
        keep = (probs.cumsum(-1) - probs) <= sc.top_p
        keep[..., :min_tokens_to_keep] = True
        kth = keep.sum(-1) - 1
        cutoff = torch.gather(topv, -1, kth[..., None])
        scores = scores.masked_fill(scores < cutoff, float("-inf"))
    return scores


def _beam_decode(params: Dict[str, Any], cfg: GPTConfig, sc: SamplingConfig,
                 prefix_emb: torch.Tensor, pad_keep: torch.Tensor,
                 generator: Optional[torch.Generator], num_beams: int,
                 length_penalty: float, stochastic: bool,
                 reorder: str = "anc",
                 live: Optional[torch.Tensor] = None) -> GenerateResult:
    """Beam search (``stochastic=False``) or beam sampling over a split KV
    cache; returns the best hypothesis per row. prefix_emb (B, S0, C) ends
    with the start_mel slot; ``live`` (B,) bool marks batch-padding rows
    False, which are done from step 0. The step counter stays on the host,
    and "every row done" is checked on the host every 8 steps."""
    if reorder not in BEAM_REORDERS:
        raise NotImplementedError(
            f"beam reorder strategy {reorder!r} is not ported yet (the port "
            f"has {BEAM_REORDERS}): ROADMAP queue A, item 15")
    b, s0, _ = prefix_emb.shape
    dev, dtype = prefix_emb.device, prefix_emb.dtype
    nb = num_beams
    bn = b * nb
    n_cand = 2 * nb
    max_steps = sc.max_mel_tokens
    vocab = cfg.number_mel_codes
    stop = cfg.stop_mel_token
    anc = reorder == "anc"

    pcache = gpt_model.init_cache(cfg, b, s0, dtype, dev)
    h = gpt_model.trunk_prefill(params, cfg, prefix_emb, pad_keep, pcache)
    if anc:
        kg, vg = gpt_model.init_gen_cache_anc(cfg, b, nb, max_steps, dtype, dev)
    else:
        kg, vg = gpt_model.init_gen_cache(cfg, bn, max_steps, dtype, dev)
    cache = gpt_model.SplitCache(pcache.k, pcache.v, kg, vg)

    beams = torch.arange(nb, device=dev)
    row_off = torch.arange(b, device=dev)[:, None] * nb         # (B, 1)
    rows_bn = torch.arange(bn, device=dev)
    rank = torch.arange(n_cand, device=dev)[None, :]
    earlier = torch.ones((nb, nb), dtype=torch.bool, device=dev).tril(-1)
    # generated_len ** length_penalty for generated_len = 1..max_steps, made
    # once on the device so that no step copies a host value to the device
    norms = torch.arange(1, max_steps + 1, dtype=torch.float32,
                         device=dev).pow(float(length_penalty))

    def penalised_logp(hid, seen):
        logits = gpt_model.mel_logits_from_hidden(params, hid).float()
        logp = torch.log_softmax(logits, dim=-1)
        if sc.repetition_penalty != 1.0:
            pen = torch.where(logp > 0, logp / sc.repetition_penalty,
                              logp * sc.repetition_penalty)
            logp = torch.where(seen, pen, logp)
        if sc.typical_sampling:
            # the reference appends the typical warper as a logits processor,
            # so it runs before the beam scores are added
            logp = _typical_filter(logp, sc.typical_mass, min_tokens_to_keep=2)
        return logp

    def select_candidates(logp, beam_scores):
        """2·nb candidates per row, sorted by score: (scores, source beam,
        token, best flat score), each (B, 2·nb) but the last (B,)."""
        scores = logp + beam_scores[:, None]
        if stochastic:
            scores = _warp_scores(scores, sc)
        flat = scores.reshape(b, nb * vocab)
        z = flat
        if stochastic:
            z = torch.where(torch.isneginf(flat), float("-inf"),
                            flat + _gumbel(flat.shape, generator, dev))
        idx = _top_k(z, n_cand)[1]
        cand = torch.gather(flat, 1, idx)
        order = torch.argsort(-cand, dim=1, stable=True)
        cand = torch.gather(cand, 1, order)
        idx = torch.gather(idx, 1, order)
        return cand, idx // vocab, idx % vocab, flat.max(dim=1).values

    def rows_of(x, src):
        """Gather the beams of each row: x (B·nb, ...) by src (B, k)."""
        xv = x.reshape(b, nb, -1)
        return torch.gather(xv, 1, src[..., None].expand(-1, -1, xv.shape[2]))

    def reorder_cache(st, src, j):
        if anc:
            # slot j-1 was just written by physical == logical beam: stamp it
            # identity, then compose the whole map with the switch (at j = 0
            # the stamp lands on slot 0, as the JAX update's clamped index
            # does; a later step overwrites it)
            st.amap[:, :, max(j - 1, 0)] = beams
            st.amap = torch.gather(st.amap, 1,
                                   src[..., None].expand(-1, -1, max_steps))
            return
        # copy-on-fork: the first beam to claim a physical row keeps it; each
        # later claim (a fork) takes a row that no beam claimed and copies
        # the ancestor's history [0, j) there. Sources and destinations are
        # disjoint, so the copy runs in place.
        src_phys = torch.gather(st.m.reshape(b, nb) - row_off, 1, src)
        first_claim = ~((src[:, :, None] == src[:, None, :]) & earlier).any(2)
        kept = (src_phys[:, :, None] == beams[None, None, :]).any(1)
        free_first = torch.argsort(kept.int(), dim=1, stable=True)
        fork_rank = (torch.cumsum(~first_claim, dim=1) - 1).clamp_min(0)
        m_new = torch.where(first_claim, src_phys,
                            torch.gather(free_first, 1, fork_rank))
        cp = torch.full((b, nb), -1, dtype=torch.long, device=dev).scatter(
            1, m_new, torch.where(first_claim, -1, src_phys))
        cp = torch.where(cp >= 0, row_off + cp, -1).reshape(bn)
        st.m = (row_off + m_new).reshape(bn)
        st.inv = (row_off + torch.zeros_like(m_new).scatter(
            1, m_new, beams.expand(b, nb))).reshape(bn)
        permute.copy_on_fork(cache.kg, cache.vg, cp.int(), j - 1)

    def process(st, cand, src_beam, tok, best_next, j):
        """BeamSearchScorer.process and the finished pool, for a step that
        has generated j tokens before it (an eos hypothesis has length
        j + 1, the eos counted)."""
        norm = norms[j]
        is_eos = tok == stop
        eos_cand = is_eos & (rank < nb) & ~st.done[:, None]
        cand_norm = torch.where(eos_cand, cand / norm, float("-inf"))
        all_norm = torch.cat([st.pool_norm, cand_norm], dim=1)
        all_len = torch.cat([st.pool_len, torch.full_like(cand_norm, j,
                                                          dtype=torch.long)], 1)
        all_tok = torch.cat([st.pool_tok, rows_of(st.tokens, src_beam)], 1)
        st.pool_norm, top_i = _top_k(all_norm, nb)
        st.pool_len = torch.gather(all_len, 1, top_i)
        st.pool_tok = torch.gather(
            all_tok, 1, top_i[..., None].expand(-1, -1, max_steps))
        # live beams: the first nb non-eos candidates in rank order
        slot = torch.cumsum(~is_eos, dim=1) - 1
        pick = torch.argmax(((slot[:, None, :] == beams[None, :, None])
                             & ~is_eos[:, None, :]).int(), dim=2)   # (B, nb)
        done = st.done[:, None]
        # finished rows freeze: stop at score 0, beams kept in place
        st.beam_scores = torch.where(done, 0.0, torch.gather(cand, 1, pick)
                                     ).reshape(bn)
        new_tok = torch.where(done, stop, torch.gather(tok, 1, pick)).reshape(bn)
        new_src = torch.where(done, beams[None, :],
                              torch.gather(src_beam, 1, pick))
        st.tokens = rows_of(st.tokens, new_src).reshape(bn, -1)
        st.seen = rows_of(st.seen, new_src).reshape(bn, -1)
        reorder_cache(st, new_src, j)
        # column j is still stop in every row, and a finished row's new
        # token is stop, so the write leaves finished rows as they were
        st.tokens[:, j] = new_tok
        st.seen[rows_bn, new_tok] = True
        st.prev = new_tok
        # done (early_stopping=False): the pool is full and no open beam can
        # still beat its worst hypothesis
        pool_full = (st.pool_norm > float("-inf")).sum(1) >= nb
        worst = st.pool_norm.min(dim=1).values
        st.done = st.done | (pool_full & (worst >= best_next / norm))

    seen = torch.zeros((bn, vocab), dtype=torch.bool, device=dev)
    seen[:, sc.fake_prefix_id] = True
    seen[:, cfg.start_mel_token] = True
    if stochastic or nb == 1:
        beam_scores = torch.zeros((bn,), dtype=torch.float32, device=dev)
    else:
        beam_scores = torch.full((b, nb), _BEAM_NEG, dtype=torch.float32,
                                 device=dev)
        beam_scores[:, 0] = 0.0
        beam_scores = beam_scores.reshape(bn)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    if live is not None:
        done = done | ~live
    st = SimpleNamespace(
        tokens=torch.full((bn, max_steps), stop, dtype=torch.long, device=dev),
        seen=seen, beam_scores=beam_scores, prev=None, done=done,
        pool_norm=torch.full((b, nb), float("-inf"), device=dev),
        pool_tok=torch.full((b, nb, max_steps), stop, dtype=torch.long,
                            device=dev),
        pool_len=torch.zeros((b, nb), dtype=torch.long, device=dev),
        # cof: logical → physical and physical → logical row maps
        m=rows_bn, inv=rows_bn,
        # anc: (B, nb, G) logical beam × gen slot → physical beam in its row
        amap=beams[None, :, None].expand(b, nb, max_steps).contiguous())

    logp = penalised_logp(h.repeat_interleave(nb, dim=0), st.seen)
    process(st, *select_candidates(logp, st.beam_scores), 0)
    j = 1
    while j < max_steps:
        if j % _DONE_CHECK_EVERY == 0 and bool(st.done.all()):
            break
        emb = (params["mel_emb"]["w"][st.prev]
               + params["mel_pos"]["w"][j + 1]).to(dtype)
        if anc:
            hh = gpt_model.trunk_decode_step_split_anc(
                params, cfg, emb, cache, j - 1, pad_keep, nb, st.amap)
        else:
            # the trunk runs in physical row order: embeddings go in by the
            # physical → logical map, hidden states come out by the inverse
            hh = gpt_model.trunk_decode_step_split(
                params, cfg, emb[st.inv], cache, j - 1, pad_keep, nb)[st.m]
        logp = penalised_logp(hh, st.seen)
        process(st, *select_candidates(logp, st.beam_scores), j)
        j += 1

    # finalize: open beams of rows not done join the pool at max_steps
    fin_norm = st.beam_scores.reshape(b, nb) / norms[max_steps - 1]
    fin_norm = torch.where(st.done[:, None], float("-inf"), fin_norm)
    all_norm = torch.cat([st.pool_norm, fin_norm], dim=1)
    all_len = torch.cat([st.pool_len, torch.full_like(st.pool_len, max_steps)],
                        dim=1)
    all_tok = torch.cat([st.pool_tok, st.tokens.reshape(b, nb, -1)], dim=1)
    best = torch.argmax(all_norm, dim=1)
    rows = torch.arange(b, device=dev)
    out_len = all_len[rows, best]
    # stop-pad past the hypothesis length (a pooled row may carry tokens of
    # the beam that went on after its eos)
    out = torch.where(torch.arange(max_steps, device=dev)[None, :]
                      < out_len[:, None], all_tok[rows, best], stop)
    return GenerateResult(out, out_len, j)


def generate_beam(params: Dict[str, Any], cfg: GPTConfig, sc: SamplingConfig,
                  prefix_emb: torch.Tensor, pad_keep: torch.Tensor,
                  num_beams: int = 3, length_penalty: float = 0.0,
                  live: Optional[torch.Tensor] = None) -> GenerateResult:
    """Deterministic beam search (HF beam_search, do_sample=False)."""
    return _beam_decode(params, cfg, sc, prefix_emb, pad_keep, None,
                        num_beams, length_penalty, stochastic=False,
                        live=live)


def generate_beam_sample(params: Dict[str, Any], cfg: GPTConfig,
                         sc: SamplingConfig, prefix_emb: torch.Tensor,
                         pad_keep: torch.Tensor,
                         generator: Optional[torch.Generator],
                         num_beams: int = 3, length_penalty: float = 0.0,
                         live: Optional[torch.Tensor] = None
                         ) -> GenerateResult:
    """Beam sampling (HF beam_sample), the reference's default decode:
    candidates drawn without replacement by Gumbel top-k."""
    return _beam_decode(params, cfg, sc, prefix_emb, pad_keep, generator,
                        num_beams, length_penalty, stochastic=True,
                        live=live)
