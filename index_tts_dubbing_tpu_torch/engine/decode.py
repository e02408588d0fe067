"""Autoregressive mel-code decoding (sampling and greedy): prefill, then one
decode step per token over a KV cache allocated once.

Counterpart of the JAX package's ``engine/decode.py`` for ``num_beams=1``;
semantics kept from the reference:

- left-padded [pad][cond(32)][start, text, stop] prefix with per-row text
  positions restarting at 0;
- decode starts from the start_mel token appended to the prefix;
- generated token j (1-based) takes mel position j+1 (tortoise off-by-one);
- HF sampling order: repetition penalty over all previously seen ids
  (including the all-ones fake prefix ids and the start token, so ids 1 and
  8192 are penalised from step 0) → typical → temperature → top-k → top-p;
- each row stops at stop_mel_token; finished rows emit stop_mel.

Beam search (the JAX package's ``_beam_decode``) is the next slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.config import GPTConfig
from index_tts_dubbing_tpu_torch.models import gpt as gpt_model

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
