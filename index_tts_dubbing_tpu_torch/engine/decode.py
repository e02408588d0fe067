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

Every decode takes ``mesh=``: each data group decodes its contiguous rows
of the global batch, tensor-parallel over ``model`` (models/gpt.py), and
the codes are gathered back, as the JAX decode shards its batch.

The beam decode keeps each beam's history by an ancestry map ("anc") and
its step counter on the device, so one step reads no host value; given a
caller's ``BeamWorkspaces`` on a card, it captures that step once as a
CUDA graph per shape and replays it at every later step.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.config import GPTConfig
from index_tts_dubbing_tpu_torch.models import gpt as gpt_model
from index_tts_dubbing_tpu_torch.ops import step_norm
from index_tts_dubbing_tpu_torch.ops.anc_attention import anc_attention
from index_tts_dubbing_tpu_torch.parallel import mesh as tp
from index_tts_dubbing_tpu_torch.utils import profiling

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
    # beam sampling's warpers (temperature, top-k, top-p) on each step's
    # log-probabilities before the beam scores are added, as transformers
    # runs them since its warpers became logits processors (the release
    # IndexTTS-2 pins); off: on the sum, as 4.36's beam_sample, where a
    # temperature compounds over the steps (both keep the same sets at
    # temperature 1)
    warp_each_step: bool = False


def prepare_prefix_host(cfg: GPTConfig, texts: Sequence[np.ndarray],
                        pad_to: Optional[int] = None,
                        cond_n: Optional[int] = None
                        ) -> Dict[str, np.ndarray]:
    """Host-side prefix layout: each row stripped of start/stop tokens,
    re-framed as [start, text, stop] and left-padded to the common width.
    Returns ids/pos/seg/cond_idx arrays of shape (B, cond_n+L+2);
    ``cond_n``: the conditioning rows (None: the 32 latents; IndexTTS-2
    adds two duration rows)."""
    if cond_n is None:
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


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """Log-softmax over the last axis, rounded as the JAX package's
    (``jax.nn.log_softmax``): ``(x - max) - log(sum(exp(x - max)))``.
    ``torch.log_softmax`` rounds ``x - (max + log(sum(...)))`` and parts
    from it by an ulp on about a third of the entries, which at a near-tie
    moves the edge of the typical set."""
    s = x - x.amax(dim=-1, keepdim=True)
    return s - torch.log(torch.exp(s).sum(dim=-1, keepdim=True))


def _typical_filter(logits: torch.Tensor, mass: float,
                    min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Locally-typical filtering: keep the tokens whose |surprisal − entropy|
    is smallest, up to cumulative probability ``mass``."""
    logp = _log_softmax(logits)
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


class _Rows:
    """The batch rows this rank decodes: under a mesh each data group takes
    its contiguous rows of the global batch; without one, every row.

    Sampling draws for the global batch from the one generator and then
    cuts out these rows, so a mesh samples what one process samples. Under
    a mesh the dead rows after the last live one (the engine's padding to a
    multiple of ``data``) draw nothing: the draws are those of one process
    on the unpadded batch."""

    def __init__(self, mesh, b: int, live: Optional[torch.Tensor] = None):
        self.mesh = mesh
        self.b = self.n_draw = b
        if mesh is None:
            return
        if b % tp.axis_size(mesh, "data"):
            raise ValueError(f"batch {b} does not divide by the data axis "
                             f"({tp.axis_size(mesh, 'data')})")
        if live is not None and bool(live.any()):
            self.n_draw = int(torch.nonzero(live).max()) + 1

    def local(self, x):
        """This rank's rows of a global (B, ...) tensor."""
        if self.mesh is None or x is None:
            return x
        return tp.data_shard(self.mesh, x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows back into the global batch."""
        return x if self.mesh is None else tp.replicate(self.mesh, x)

    def drawn(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of draws made for the first ``n_draw`` rows of
        the global batch (zeros for the padding rows)."""
        if self.n_draw < self.b:
            x = torch.cat([x, x.new_zeros((self.b - self.n_draw,)
                                          + x.shape[1:])])
        return self.local(x)

    def all_done(self, done: torch.Tensor) -> bool:
        """Whether every row is done; under a mesh, on every rank of the
        world (the ranks of a model group share collectives, so all stop on
        the same step)."""
        if self.mesh is None:
            return bool(done.all())
        return tp.all_true(self.mesh, done)


class GenerateResult(NamedTuple):
    codes: torch.Tensor     # (B, max_steps) generated mel codes, stop-padded
    lengths: torch.Tensor   # (B,) codes before the stop token
    steps: int              # decode iterations executed


def generate(params: Dict[str, Any], cfg: GPTConfig, sc: SamplingConfig,
             prefix_emb: torch.Tensor, pad_keep: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             live: Optional[torch.Tensor] = None,
             mesh=None) -> GenerateResult:
    """Sample (or, with ``do_sample=False``, greedily pick) mel codes.
    prefix_emb (B, S0, C) ends with the start_mel slot. ``live`` (B,) bool
    marks batch-padding rows False: they emit stop at step 0 and never keep
    the loop running. The loop runs at most ``sc.max_mel_tokens`` steps.
    ``mesh``: a (data, model) mesh (parallel/mesh.py) with ``params``
    sharded over ``model``; the inputs are the global batch, each data group
    decodes its rows and the result is the global batch again."""
    with tp.use(mesh):
        return _generate(params, cfg, sc, prefix_emb, pad_keep, generator,
                         live, _Rows(mesh, prefix_emb.shape[0], live))


def _generate(params, cfg, sc, prefix_emb, pad_keep, generator, live,
              part: _Rows) -> GenerateResult:
    prefix_emb, pad_keep, live = (part.local(t) for t in
                                  (prefix_emb, pad_keep, live))
    b, s0, _ = prefix_emb.shape
    dev = prefix_emb.device
    max_steps = sc.max_mel_tokens
    s_total = s0 + max_steps

    def sample_token(hidden):
        logits = _process_logits(
            gpt_model.mel_logits_from_hidden(params, hidden), seen, sc)
        if sc.do_sample:
            probs = part.gather(torch.softmax(logits, dim=-1))
            return part.drawn(torch.multinomial(probs[:part.n_draw], 1,
                                                generator=generator))[:, 0]
        return torch.argmax(logits, dim=-1)

    with profiling.span("decode.prefill", device=dev):
        cache = gpt_model.init_cache(cfg, b, s_total, prefix_emb.dtype, dev)
        h = gpt_model.trunk_prefill(params, cfg, prefix_emb, pad_keep, cache)
        # slot validity: prefix pads stay masked, generated slots open as the
        # loop advances
        keep = torch.cat([pad_keep, torch.zeros((b, max_steps),
                                                dtype=torch.bool,
                                                device=dev)], dim=1)
        rows = torch.arange(b, device=dev)
        seen = torch.zeros((b, cfg.number_mel_codes), dtype=torch.bool,
                           device=dev)
        seen[:, sc.fake_prefix_id] = True
        seen[:, cfg.start_mel_token] = True
        stop = torch.full((), cfg.stop_mel_token, dtype=torch.long,
                          device=dev)
        tok = sample_token(h)
        if live is not None:
            tok = torch.where(live, tok, stop)
        done = tok == stop
        tokens = torch.full((b, max_steps), cfg.stop_mel_token,
                            dtype=torch.long, device=dev)
        tokens[:, 0] = tok
        seen[rows, tok] = True
    j = 1
    while j < max_steps:
        if j % _DONE_CHECK_EVERY == 0:
            with profiling.sync("done"):
                finished = part.all_done(done)
            if finished:
                break
        with profiling.span("decode.step", graph=0, anc_attn=0,
                            step_norm=0):
            # previous token at mel position j+1 (parity quirk)
            emb = (params["mel_emb"]["w"][tok]
                   + params["mel_pos"]["w"][j + 1]).to(prefix_emb.dtype)
            slot = s0 + j - 1
            keep[:, slot] = True
            hh = gpt_model.trunk_decode_step(params, cfg, emb, cache, slot,
                                             keep)
            tok = torch.where(done, stop, sample_token(hh))
            done = done | (tok == stop)
            tokens[:, j] = tok
            seen[rows, tok] = True
        j += 1
    is_stop = tokens == cfg.stop_mel_token
    first_stop = torch.argmax(is_stop.int(), dim=1)
    lengths = torch.where(is_stop.any(dim=1), first_stop,
                          torch.full_like(first_stop, max_steps))
    return GenerateResult(part.gather(tokens), part.gather(lengths), j)


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
# The history: HF ``_reorder_cache`` gathers the whole cache every step;
# here no cache row ever moves. The cache is split (gpt.SplitCache): the
# prefix once per batch row, the gen region per beam in the heads-major
# ancestry layout (L, B, H, nb, G, D). An ancestry map (B, nb, G) says
# which physical beam of its row holds each logical beam's gen slot; a
# step scores against every physical beam and attention takes the
# ancestor's (gpt.trunk_decode_step_split_anc), and a beam switch composes
# the map alone. The JAX package's ``engine/decode.py`` keeps its other
# history strategies, which the tests compare against.

_BEAM_NEG = -1e9


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


def _at(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``x[j]`` along the first axis for a 0-d device tensor ``j``, read on
    the device, with no sync."""
    return x.index_select(0, j.reshape(1))[0]


def _beam_decode(params: Dict[str, Any], cfg: GPTConfig, sc: SamplingConfig,
                 prefix_emb: torch.Tensor, pad_keep: torch.Tensor,
                 generator: Optional[torch.Generator], num_beams: int,
                 length_penalty: float, stochastic: bool,
                 live: Optional[torch.Tensor] = None,
                 mesh=None,
                 workspaces: Optional[BeamWorkspaces] = None
                 ) -> GenerateResult:
    """Beam search (``stochastic=False``) or beam sampling; returns the best
    hypothesis per row. prefix_emb (B, S0, C) ends with the start_mel slot;
    ``live`` (B,) bool marks batch-padding rows False, which are done from
    step 0. The step counter lives on the device, and "every row done" is
    checked on the host every 8 steps. ``mesh``: as in ``generate``; the
    beams of a row stay on its data group. ``workspaces``: the caller's
    ``BeamWorkspaces``, where a decode without a mesh runs over the
    workspace of its shape, on a card each step a CUDA graph's replay;
    without it every step runs eagerly."""
    if mesh is not None:
        workspaces = None
    with tp.use(mesh):
        return _beam(params, cfg, sc, prefix_emb, pad_keep, generator,
                     num_beams, length_penalty, stochastic, live,
                     _Rows(mesh, prefix_emb.shape[0], live), workspaces)


class _Beam:
    """One beam decode's fixed part: the weights, the settings, the shape
    (B rows of nb beams, a prefix of S0 slots, G = ``max_mel_tokens``
    generated ones) and the constants made once on the device. Its methods
    run the prefill, the steps and the finalize over a state ``st``
    (``new_state``): every tensor a decode updates, each updated in place
    and never rebound."""

    def __init__(self, params, cfg: GPTConfig, sc: SamplingConfig,
                 generator: Optional[torch.Generator], num_beams: int,
                 length_penalty: float, stochastic: bool, part: _Rows, b: int,
                 s0: int, dev, dtype):
        self.params, self.cfg, self.sc = params, cfg, sc
        self.generator, self.stochastic = generator, stochastic
        self.part = part
        self.b, self.nb, self.s0 = b, num_beams, s0
        self.bn = b * num_beams
        self.n_cand = 2 * num_beams
        self.max_steps = sc.max_mel_tokens
        self.vocab = cfg.number_mel_codes
        self.stop = cfg.stop_mel_token
        self.dev, self.dtype = dev, dtype
        self.beams = torch.arange(num_beams, device=dev)
        self.rows_bn = torch.arange(self.bn, device=dev)
        self.rank = torch.arange(self.n_cand, device=dev)[None, :]
        self.true = torch.ones((), dtype=torch.bool, device=dev)
        # generated_len ** length_penalty for generated_len = 1..max_steps,
        # made once on the device so that no step copies a host value to
        # the device
        self.norms = torch.arange(1, self.max_steps + 1, dtype=torch.float32,
                                  device=dev).pow(float(length_penalty))

    # -- the state --------------------------------------------------------
    def new_state(self) -> SimpleNamespace:
        """The tensors a decode updates, zeros or unset; ``reset`` sets
        their values. The cache: the prefix (L, B, H, S0, D) and the gen
        region in the ancestry layout (L, B, H, nb, G, D)."""
        b, nb, bn, g, dev = self.b, self.nb, self.bn, self.max_steps, self.dev
        cfg, dtype = self.cfg, self.dtype
        long = dict(dtype=torch.long, device=dev)
        return SimpleNamespace(
            cache=gpt_model.SplitCache(
                *gpt_model.init_cache(cfg, b, self.s0, dtype, dev),
                *gpt_model.init_gen_cache_anc(cfg, b, nb, g, dtype, dev)),
            tokens=torch.empty((bn, g), **long),
            seen=torch.empty((bn, self.vocab), dtype=torch.bool, device=dev),
            beam_scores=torch.empty((bn,), dtype=torch.float32, device=dev),
            prev=torch.empty((bn,), **long),
            done=torch.empty((b,), dtype=torch.bool, device=dev),
            pool_norm=torch.empty((b, nb), dtype=torch.float32, device=dev),
            pool_tok=torch.empty((b, nb, g), **long),
            pool_len=torch.empty((b, nb), **long),
            # (B, nb, G) logical beam × gen slot → physical beam in its row
            amap=torch.empty((b, nb, g), **long),
            # the tokens generated so far, on the device
            j=torch.zeros((), **long),
            pad_keep=torch.empty((b, self.s0), dtype=torch.bool, device=dev))

    def reset(self, st: SimpleNamespace, pad_keep: torch.Tensor,
              live: Optional[torch.Tensor]) -> None:
        """Set a state's values for a new decode, in place."""
        st.tokens.fill_(self.stop)
        st.seen.zero_()
        st.seen[:, self.sc.fake_prefix_id] = True
        st.seen[:, self.cfg.start_mel_token] = True
        st.beam_scores.zero_()
        if not (self.stochastic or self.nb == 1):
            # beam search: beams 1.. start at -1e9 (module comment above)
            st.beam_scores.view(self.b, self.nb)[:, 1:] = _BEAM_NEG
        st.done.zero_()
        if live is not None:
            st.done |= ~live
        st.pool_norm.fill_(float("-inf"))
        st.pool_tok.fill_(self.stop)
        st.pool_len.zero_()
        st.amap.copy_(self.beams[None, :, None].expand(st.amap.shape))
        st.j.zero_()
        st.pad_keep.copy_(pad_keep)

    # -- a decode ---------------------------------------------------------
    def prefill(self, prefix_emb: torch.Tensor, pad_keep: torch.Tensor,
                live: Optional[torch.Tensor],
                st: Optional[SimpleNamespace] = None
                ) -> Tuple[SimpleNamespace, torch.Tensor]:
        """The prefix through the trunk into the cache's prefix, and the
        state set for a new decode: (st, the hidden state (B, C) of the
        prefix's last position). ``st``: a state to decode over again (a
        workspace's); otherwise a new state. Its gen cache keeps the last
        decode's K/V: a step writes slot j - 1 before it attends to it, and
        the slots after it take an additive ``_NEG`` bias, so their finite
        stale values get a weight of exactly 0, as the zeros of a new cache
        do."""
        if st is None:
            st = self.new_state()
        h = gpt_model.trunk_prefill(self.params, self.cfg, prefix_emb,
                                    pad_keep, gpt_model.KVCache(st.cache.kp,
                                                                st.cache.vp))
        self.reset(st, pad_keep, live)
        return st, h

    def first_step(self, st: SimpleNamespace, h: torch.Tensor) -> None:
        """Step 0, on the prefill's hidden state."""
        logp = self.penalised_logp(h.repeat_interleave(self.nb, dim=0),
                                   st.seen)
        self.select(st, logp, st.j)
        st.j += 1

    def step(self, st: SimpleNamespace) -> None:
        """The step after ``st.j`` generated tokens: the previous token's
        embedding at mel position j + 1 (parity quirk), the trunk, the
        selection; then it advances ``st.j``. Every value the step reads
        is on the device and every tensor it writes is written in place, so
        a CUDA graph captures the step whole (``BeamWorkspaces``)."""
        j, w = st.j, self.params
        emb = (w["mel_emb"]["w"][st.prev]
               + _at(w["mel_pos"]["w"], j + 1)).to(self.dtype)
        self.select(st, self.penalised_logp(self.trunk_step(st, emb, j),
                                            st.seen), j)
        st.j += 1

    def finalize(self, st: SimpleNamespace, steps: int) -> GenerateResult:
        """Open beams of rows not done join the pool at max_steps; the best
        hypothesis per row, in new tensors (a workspace's state may serve
        the next decode before they are read)."""
        b, nb, max_steps, dev = self.b, self.nb, self.max_steps, self.dev
        fin_norm = st.beam_scores.reshape(b, nb) / self.norms[max_steps - 1]
        fin_norm = torch.where(st.done[:, None], float("-inf"), fin_norm)
        all_norm = torch.cat([st.pool_norm, fin_norm], dim=1)
        all_len = torch.cat([st.pool_len,
                             torch.full_like(st.pool_len, max_steps)], dim=1)
        all_tok = torch.cat([st.pool_tok, st.tokens.reshape(b, nb, -1)],
                            dim=1)
        best = torch.argmax(all_norm, dim=1)
        rows = torch.arange(b, device=dev)
        out_len = all_len[rows, best]
        # stop-pad past the hypothesis length (a pooled row may carry tokens
        # of the beam that went on after its eos)
        out = torch.where(torch.arange(max_steps, device=dev)[None, :]
                          < out_len[:, None], all_tok[rows, best], self.stop)
        return GenerateResult(self.part.gather(out),
                              self.part.gather(out_len), steps)

    # -- the pieces of a step ---------------------------------------------
    def penalised_logp(self, hid: torch.Tensor, seen: torch.Tensor
                       ) -> torch.Tensor:
        sc = self.sc
        logits = gpt_model.mel_logits_from_hidden(self.params, hid).float()
        logp = _log_softmax(logits)
        if sc.repetition_penalty != 1.0:
            pen = torch.where(logp > 0, logp / sc.repetition_penalty,
                              logp * sc.repetition_penalty)
            logp = torch.where(seen, pen, logp)
        if sc.typical_sampling:
            # the reference appends the typical warper as a logits processor,
            # so it runs before the beam scores are added
            logp = _typical_filter(logp, sc.typical_mass, min_tokens_to_keep=2)
        return logp

    def select(self, st: SimpleNamespace, logp: torch.Tensor,
               j: torch.Tensor) -> None:
        self.process(st, *self.select_candidates(logp, st.beam_scores), j)

    def select_candidates(self, logp: torch.Tensor, beam_scores: torch.Tensor):
        """2·nb candidates per row, sorted by score: (scores, source beam,
        token, best flat score), each (B, 2·nb) but the last (B,)."""
        part, vocab = self.part, self.vocab
        if self.stochastic and self.sc.warp_each_step:
            scores = _warp_scores(logp, self.sc) + beam_scores[:, None]
        else:
            scores = logp + beam_scores[:, None]
            if self.stochastic:
                scores = _warp_scores(scores, self.sc)
        flat = scores.reshape(self.b, self.nb * vocab)
        z = flat
        if self.stochastic:
            noise = part.drawn(_gumbel((part.n_draw,) + flat.shape[1:],
                                       self.generator, self.dev))
            z = torch.where(torch.isneginf(flat), float("-inf"), flat + noise)
        idx = _top_k(z, self.n_cand)[1]
        cand = torch.gather(flat, 1, idx)
        order = torch.argsort(-cand, dim=1, stable=True)
        cand = torch.gather(cand, 1, order)
        idx = torch.gather(idx, 1, order)
        return cand, idx // vocab, idx % vocab, flat.max(dim=1).values

    def rows_of(self, x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        """Gather the beams of each row: x (B·nb, ...) by src (B, k)."""
        xv = x.reshape(self.b, self.nb, -1)
        return torch.gather(xv, 1, src[..., None].expand(-1, -1, xv.shape[2]))

    def reorder_cache(self, st: SimpleNamespace, src: torch.Tensor,
                      j: torch.Tensor) -> None:
        """Apply the beam switch ``src`` (B, nb: each new beam's source
        beam in its row) to the history, after the step that generated j
        tokens before it: slot j - 1 was just written by physical ==
        logical beam, so it is stamped identity, then the whole map is
        composed with the switch. At j = 0 the stamp lands on slot 0, as
        the JAX update's clamped index does (a later step overwrites
        it)."""
        nn.write_slot(st.amap, 2, (j - 1).clamp_min(0), self.beams)
        st.amap.copy_(torch.gather(st.amap, 1, src[..., None].expand(
            -1, -1, st.amap.shape[2])))

    def process(self, st: SimpleNamespace, cand: torch.Tensor,
                src_beam: torch.Tensor, tok: torch.Tensor,
                best_next: torch.Tensor, j: torch.Tensor) -> None:
        """BeamSearchScorer.process and the finished pool, for a step that
        has generated j tokens before it (an eos hypothesis has length
        j + 1, the eos counted)."""
        nb, stop, beams = self.nb, self.stop, self.beams
        norm = _at(self.norms, j)
        is_eos = tok == stop
        eos_cand = is_eos & (self.rank < nb) & ~st.done[:, None]
        cand_norm = torch.where(eos_cand, cand / norm, float("-inf"))
        all_norm = torch.cat([st.pool_norm, cand_norm], dim=1)
        all_len = torch.cat([st.pool_len,
                             torch.zeros_like(cand_norm, dtype=torch.long)
                             + j], 1)
        all_tok = torch.cat([st.pool_tok, self.rows_of(st.tokens, src_beam)],
                            1)
        pool_norm, top_i = _top_k(all_norm, nb)
        st.pool_norm.copy_(pool_norm)
        st.pool_len.copy_(torch.gather(all_len, 1, top_i))
        st.pool_tok.copy_(torch.gather(
            all_tok, 1, top_i[..., None].expand(-1, -1, self.max_steps)))
        # live beams: the first nb non-eos candidates in rank order
        slot = torch.cumsum(~is_eos, dim=1) - 1
        pick = torch.argmax(((slot[:, None, :] == beams[None, :, None])
                             & ~is_eos[:, None, :]).int(), dim=2)   # (B, nb)
        done = st.done[:, None]
        # finished rows freeze: stop at score 0, beams kept in place
        st.beam_scores.copy_(torch.where(done, 0.0, torch.gather(cand, 1, pick)
                                         ).reshape(self.bn))
        new_tok = torch.where(done, stop, torch.gather(tok, 1, pick)
                              ).reshape(self.bn)
        new_src = torch.where(done, beams[None, :],
                              torch.gather(src_beam, 1, pick))
        st.tokens.copy_(self.rows_of(st.tokens, new_src).reshape(self.bn, -1))
        st.seen.copy_(self.rows_of(st.seen, new_src).reshape(self.bn, -1))
        self.reorder_cache(st, new_src, j)
        # column j is still stop in every row, and a finished row's new
        # token is stop, so the write leaves finished rows as they were
        nn.write_slot(st.tokens, 1, j, new_tok)
        st.seen.index_put_((self.rows_bn, new_tok), self.true)
        st.prev.copy_(new_tok)
        # done (early_stopping=False): the pool is full and no open beam can
        # still beat its worst hypothesis
        pool_full = (st.pool_norm > float("-inf")).sum(1) >= nb
        worst = st.pool_norm.min(dim=1).values
        st.done |= pool_full & (worst >= best_next / norm)

    def trunk_step(self, st: SimpleNamespace, emb: torch.Tensor,
                   j: torch.Tensor) -> torch.Tensor:
        """Hidden states (B·nb, C) of the step after j - 1 generated
        tokens; writes its K/V at gen slot j - 1. The trunk step is read
        from models/gpt.py at each call, so a caller may wrap it there."""
        return gpt_model.trunk_decode_step_split_anc(
            self.params, self.cfg, emb, st.cache, j - 1, st.pad_keep, self.nb,
            st.amap)


# eager steps a workspace runs on its capture stream before it
# captures the step
_GRAPH_WARMUP = 3
# the share of a card's memory that the workspaces kept between decodes may
# take (``BeamWorkspaces``)
_KEEP_SHARE = 0.125


def _step_launches(fn, *args) -> Tuple[int, int]:
    """``fn(*args)``; the K3 and the K4 launches it made (or captured)."""
    anc, norm = anc_attention.launches, step_norm.launches()
    fn(*args)
    return anc_attention.launches - anc, step_norm.launches() - norm


def _keep_bytes(dev: torch.device) -> float:
    """The memory the workspaces on ``dev`` may keep between decodes:
    ``_KEEP_SHARE`` of a card's; no bound off a card, where the engine
    passes none."""
    if dev.type != "cuda":
        return float("inf")
    return _KEEP_SHARE * torch.cuda.get_device_properties(dev).total_memory


class _Workspace:
    """The beam decode of one shape and setting: its ``_Beam``, its state,
    and on a card the step as a CUDA graph, captured once warmed up.
    ``nbytes``: the memory it keeps, its state's tensors and its graph's
    memory pool. ``anc_attn`` and ``step_norm``: the K3 and the K4
    launches a step holds (those of its last eager step, then those its
    graph captured): on a card one K3 launch a layer and 3 × layers + 1 K4
    launches."""

    def __init__(self, beam: _Beam, owner: BeamWorkspaces):
        self.beam, self.owner = beam, owner
        self.st = beam.new_state()
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in (*self.st.cache, *vars(self.st).values())
                          if torch.is_tensor(t))
        self.cuda = torch.device(beam.dev).type == "cuda"
        self.stream = torch.cuda.Stream(beam.dev) if self.cuda else None
        self.graph = None
        self.warm = 0
        self.anc_attn = self.step_norm = 0

    def step(self) -> bool:
        """The next step (``_Beam.step``); True where the graph ran it."""
        beam, st = self.beam, self.st
        if not self.cuda:
            self.anc_attn, self.step_norm = _step_launches(beam.step, st)
            return False
        if self.graph is None:
            if self.warm < _GRAPH_WARMUP:
                # eager on the capture's stream: the step's own work, and
                # what a capture may not do (cuBLAS's workspace for the
                # stream, the first launches, the kernel library's load)
                # done before it
                self.stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(self.stream):
                    self.anc_attn, self.step_norm = _step_launches(
                        beam.step, st)
                torch.cuda.current_stream().wait_stream(self.stream)
                self.warm += 1
                return False
            self.anc_attn, self.step_norm = _step_launches(self.capture)
        self.graph.replay()
        return True

    def capture(self) -> None:
        """Record the step into a CUDA graph without running it. Unlike
        ``torch.cuda.graph``, this keeps the allocator's cache rather than
        emptying it at each capture; the reserve the capture adds is the
        graph's memory pool."""
        beam, dev = self.beam, self.beam.dev
        graph = torch.cuda.CUDAGraph()
        if beam.generator is not None:
            # the Gumbel draws then advance the generator's Philox offset at
            # each replay, as the eager draws do
            graph.register_generator_state(beam.generator)
        torch.cuda.synchronize(dev)
        reserved = torch.cuda.memory_reserved(dev)
        with torch.cuda.stream(self.stream):
            graph.capture_begin()
            try:
                beam.step(self.st)
            finally:
                graph.capture_end()
        self.nbytes += torch.cuda.memory_reserved(dev) - reserved
        self.graph = graph
        self.owner.captures += 1
        self.owner.trim(dev)


class BeamWorkspaces:
    """A caller's beam decodes kept between calls (an engine keeps
    one): a workspace for each shape and setting, which holds the decode's
    state and, on a card, its step as a CUDA graph. The key is everything
    the graph holds fixed: the rows, beams, prefix width, cap and dtype,
    the weights, the generator and the sampling settings. The first decode
    of a key runs ``_GRAPH_WARMUP`` eager steps, then captures one step;
    every later step replays it, the host issuing one launch a step.
    Past ``_keep_bytes`` the least recently used workspaces go; the one in
    use stays, alone if it is larger. ``captures``: the graphs captured so
    far."""

    def __init__(self):
        self._ws: collections.OrderedDict = collections.OrderedDict()
        self.captures = 0

    def get(self, params, cfg: GPTConfig, sc: SamplingConfig,
            generator: Optional[torch.Generator], num_beams: int,
            length_penalty: float, stochastic: bool, part: _Rows, b: int,
            s0: int, dev, dtype) -> _Workspace:
        """The workspace of this decode, made on a miss."""
        dev = torch.device(dev)
        key = (id(params), id(cfg), id(generator), sc, num_beams,
               float(length_penalty), stochastic, b, s0, dev, dtype)
        ws = self._ws.pop(key, None)
        if ws is None:
            # room for the new one's K/V caches first, so that the memory
            # kept never holds both it and those it displaces
            self.trim(dev, 2 * cfg.layers * b * cfg.model_dim
                      * (num_beams * sc.max_mel_tokens + s0)
                      * dtype.itemsize)
            ws = _Workspace(_Beam(params, cfg, sc, generator, num_beams,
                                  length_penalty, stochastic, part, b, s0,
                                  dev, dtype), self)
        self._ws[key] = ws
        self.trim(dev)
        return ws

    def trim(self, dev: torch.device, coming: int = 0) -> None:
        """Drop the least recently used workspaces while those kept, and
        ``coming`` bytes more, take more than ``_keep_bytes(dev)``; the
        newest stays where nothing is coming."""
        while (len(self._ws) > (0 if coming else 1)
               and self.nbytes + coming > _keep_bytes(dev)):
            self._ws.popitem(last=False)

    @property
    def nbytes(self) -> int:
        return sum(ws.nbytes for ws in self._ws.values())

    def __len__(self) -> int:
        return len(self._ws)


def _beam(params, cfg, sc, prefix_emb, pad_keep, generator, num_beams,
          length_penalty, stochastic, live, part: _Rows,
          workspaces: Optional[BeamWorkspaces]) -> GenerateResult:
    prefix_emb, pad_keep, live = (part.local(t) for t in
                                  (prefix_emb, pad_keep, live))
    b, s0, _ = prefix_emb.shape
    dev, dtype = prefix_emb.device, prefix_emb.dtype
    args = (params, cfg, sc, generator, num_beams, length_penalty,
            stochastic)
    ws = None
    if workspaces is not None:
        ws = workspaces.get(*args, part, b, s0, dev, dtype)
        m = ws.beam
    else:
        m = _Beam(*args, part, b, s0, dev, dtype)
    with profiling.span("decode.prefill", device=dev):
        st, h = m.prefill(prefix_emb, pad_keep, live,
                          None if ws is None else ws.st)
        m.first_step(st, h)
    j = 1
    while j < m.max_steps:
        if j % _DONE_CHECK_EVERY == 0:
            with profiling.sync("done"):
                finished = part.all_done(st.done)
            if finished:
                break
        with profiling.span("decode.step") as sp:
            if ws is not None:
                sp.set(graph=int(ws.step()), anc_attn=ws.anc_attn,
                       step_norm=ws.step_norm)
            else:
                anc, norm = _step_launches(m.step, st)
                sp.set(graph=0, anc_attn=anc, step_norm=norm)
        j += 1
    return m.finalize(st, j)


def generate_beam(params: Dict[str, Any], cfg: GPTConfig, sc: SamplingConfig,
                  prefix_emb: torch.Tensor, pad_keep: torch.Tensor,
                  num_beams: int = 3, length_penalty: float = 0.0,
                  live: Optional[torch.Tensor] = None,
                  mesh=None, workspaces: Optional[BeamWorkspaces] = None
                  ) -> GenerateResult:
    """Deterministic beam search (HF beam_search, do_sample=False)."""
    return _beam_decode(params, cfg, sc, prefix_emb, pad_keep, None,
                        num_beams, length_penalty, stochastic=False,
                        live=live, mesh=mesh, workspaces=workspaces)


def generate_beam_sample(params: Dict[str, Any], cfg: GPTConfig,
                         sc: SamplingConfig, prefix_emb: torch.Tensor,
                         pad_keep: torch.Tensor,
                         generator: Optional[torch.Generator],
                         num_beams: int = 3, length_penalty: float = 0.0,
                         live: Optional[torch.Tensor] = None,
                         mesh=None,
                         workspaces: Optional[BeamWorkspaces] = None
                         ) -> GenerateResult:
    """Beam sampling (HF beam_sample), the reference's default decode:
    candidates drawn without replacement by Gumbel top-k."""
    return _beam_decode(params, cfg, sc, prefix_emb, pad_keep, generator,
                        num_beams, length_penalty, stochastic=True,
                        live=live, mesh=mesh, workspaces=workspaces)
