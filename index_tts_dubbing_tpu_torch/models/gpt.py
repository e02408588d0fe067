"""UnifiedVoice: GPT-2 AR decoder over [cond(32) · text · mel-code] streams.

Counterpart of the JAX package's ``models/gpt.py``: the full-sequence
trunk, prefill and single-token decode over a KV cache that is allocated
once (``init_cache``) and written in place; the beam decode's split cache
(prefix once per row, generated region per beam) with its two decode steps;
the mel head, conditioning, and the bucketed latent pass. ``params["blocks"]`` is a list
of per-layer dicts (``weights.from_jax_params`` unstacks the JAX package's
stacked layout). Attention is plain matmul → mask → softmax → matmul with
float32 scores, as in the JAX trunk.

Parity quirk kept from the reference: at decode, generated mel token j
(1-based) takes mel position j+1 (the tortoise off-by-one the checkpoints
were trained with).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.config import GPTConfig
from index_tts_dubbing_tpu_torch.models import conformer, legacy_cond, perceiver

Params = Dict[str, Any]
_NEG = -1e30


def _act(cfg: GPTConfig, x: torch.Tensor) -> torch.Tensor:
    if "tanh" in cfg.activation or cfg.activation == "gelu_new":
        return nn.gelu_tanh(x)
    return nn.gelu_exact(x)


def _mlp(cfg: GPTConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return nn.linear(p["proj"], _act(cfg, nn.linear(p["fc"], x)))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor, scale: float) -> torch.Tensor:
    """(B,H,Tq,D) × (B,H,Tk,D) with an additive float32 bias."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits + bias, dim=-1).to(v.dtype)
    return torch.matmul(w, v)


def _qkv(cfg: GPTConfig, blk: Params, x: torch.Tensor):
    q, k, v = nn.linear(blk["attn"]["qkv"], nn.layer_norm(blk["ln1"], x)
                        ).chunk(3, dim=-1)
    return (nn.split_heads(t, cfg.heads) for t in (q, k, v))


def _block_out(cfg: GPTConfig, blk: Params, x: torch.Tensor,
               o: torch.Tensor) -> torch.Tensor:
    x = x + nn.linear(blk["attn"]["proj"], nn.merge_heads(o))
    return x + _mlp(cfg, blk["mlp"], nn.layer_norm(blk["ln2"], x))


def causal_bias(t: int, pad_keep: Optional[torch.Tensor] = None,
                device=None) -> torch.Tensor:
    """Additive float32 attention bias (B or 1, 1, T, T): causal + key pad."""
    c = torch.ones((t, t), dtype=torch.bool, device=device).tril()
    zero = torch.zeros((), device=device)
    neg = torch.full((), _NEG, device=device)
    bias = torch.where(c, zero, neg)[None, None]
    if pad_keep is not None:
        bias = bias + torch.where(pad_keep, zero, neg)[:, None, None, :]
    return bias


def trunk_forward(params: Params, cfg: GPTConfig, emb: torch.Tensor,
                  pad_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence trunk: embeddings (B,T,C) → hidden after ln_f."""
    bias = causal_bias(emb.shape[1], pad_keep, emb.device)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    x = emb
    for blk in params["blocks"]:
        q, k, v = _qkv(cfg, blk, x)
        x = _block_out(cfg, blk, x, _attend(q, k, v, bias, scale))
    return nn.layer_norm(params["ln_f"], x)


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, H, S, D)
    v: torch.Tensor


def init_cache(cfg: GPTConfig, batch: int, max_len: int, dtype,
               device) -> KVCache:
    shape = (cfg.layers, batch, cfg.heads, max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def trunk_prefill(params: Params, cfg: GPTConfig, emb: torch.Tensor,
                  pad_keep: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """Run the prefix (B, T0, C), fill cache[:, :, :, :T0] in place, return
    the hidden state of the last position (B, C) after ln_f."""
    t0 = emb.shape[1]
    bias = causal_bias(t0, pad_keep, emb.device)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    x = emb
    for li, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(cfg, blk, x)
        cache.k[li, :, :, :t0] = k
        cache.v[li, :, :, :t0] = v
        x = _block_out(cfg, blk, x, _attend(q, k, v, bias, scale))
    return nn.layer_norm(params["ln_f"], x[:, -1, :])


def trunk_decode_step(params: Params, cfg: GPTConfig, x: torch.Tensor,
                      cache: KVCache, pos: int,
                      key_keep: torch.Tensor) -> torch.Tensor:
    """One decode step. x (B, C) embedding of the current token; ``pos`` the
    cache slot it occupies (written in place); key_keep (B, S) validity over
    cache slots (True = attend). Returns hidden (B, C) after ln_f."""
    kbias = torch.where(key_keep, 0.0, _NEG).float()[:, None, None, :]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    x = x[:, None, :]
    for li, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(cfg, blk, x)                    # (B,H,1,D)
        cache.k[li, :, :, pos] = k[:, :, 0]
        cache.v[li, :, :, pos] = v[:, :, 0]
        o = _attend(q, cache.k[li].to(q.dtype), cache.v[li].to(x.dtype),
                    kbias, scale)
        x = _block_out(cfg, blk, x, o)
    return nn.layer_norm(params["ln_f"], x[:, 0, :])


class SplitCache(NamedTuple):
    """Beam-decode KV cache split into a frozen prefix and a generated
    region. The prefix [cond · text · start_mel] is identical across the nb
    beams of a batch row, so it is stored once per row and shared at
    attention time; only the generated region exists per beam, and only it
    is reordered when beams switch ancestry."""
    kp: torch.Tensor  # (L, B, H, S0, D) prefix keys, frozen after prefill
    vp: torch.Tensor  # (L, B, H, S0, D)
    kg: torch.Tensor  # (L, BN, H, G, D), or (L, B, H, nb, G, D) for "anc"
    vg: torch.Tensor


def init_gen_cache(cfg: GPTConfig, bn: int, gen_len: int, dtype, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gen-region cache (L, BN, H, G, D), rows in physical beam order."""
    shape = (cfg.layers, bn, cfg.heads, gen_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_gen_cache_anc(cfg: GPTConfig, b: int, nb: int, gen_len: int, dtype,
                       device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gen-region cache in the heads-major ancestry layout
    (L, B, H, nb, G, D): a row's nb beams of one head are one contiguous
    (nb·G, D) block, so attention over every physical beam is one matmul."""
    shape = (cfg.layers, b, cfg.heads, nb, gen_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _split_biases(keep_p: torch.Tensor, g_len: int, slot: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Additive float32 biases: prefix (B, 1, 1, S0) from the pad mask, gen
    (G,) opening slots <= ``slot``."""
    pbias = torch.where(keep_p, 0.0, _NEG).float()[:, None, None, :]
    ar = torch.arange(g_len, device=keep_p.device)
    return pbias, torch.where(ar <= slot, 0.0, _NEG).float()


def trunk_decode_step_split(params: Params, cfg: GPTConfig, x: torch.Tensor,
                            cache: SplitCache, slot: int,
                            keep_p: torch.Tensor, nb: int) -> torch.Tensor:
    """One beam decode step over a SplitCache whose gen rows are in the
    order of ``x``. x (BN, C) current-token embeddings; ``slot`` the gen
    slot this step writes (attention covers gen slots <= slot); keep_p
    (B, S0) prefix validity, shared by a row's beams. Returns hidden (BN, C)
    after ln_f. The JAX step returns an updated copy of the cache; this one
    writes the new K/V slot into ``cache.kg/vg`` in place, which saves a
    copy of the gen region per layer."""
    bn = x.shape[0]
    b = bn // nb
    h, d = cfg.heads, cfg.head_dim
    g_len, s0 = cache.kg.shape[3], cache.kp.shape[3]
    pbias, gbias = _split_biases(keep_p, g_len, slot)
    scale = 1.0 / math.sqrt(d)
    for li, blk in enumerate(params["blocks"]):
        q, k, v = nn.linear(blk["attn"]["qkv"], nn.layer_norm(blk["ln1"], x)
                            ).chunk(3, dim=-1)
        q = q.reshape(bn, h, d)
        cache.kg[li, :, :, slot] = k.reshape(bn, h, d)
        cache.vg[li, :, :, slot] = v.reshape(bn, h, d)
        qf = q.float()
        # prefix scores: one prefix per batch row, shared by its beams
        lp = torch.matmul(qf.reshape(b, nb, h, d).transpose(1, 2),
                          cache.kp[li].float().transpose(-1, -2)) * scale
        lg = torch.matmul(qf[:, :, None, :],
                          cache.kg[li].float().transpose(-1, -2))[:, :, 0]
        lg = (lg * scale).reshape(b, nb, h, g_len).transpose(1, 2)
        logits = torch.cat([lp + pbias, lg + gbias], dim=-1)   # (B,H,nb,S0+G)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        wp, wg = w[..., :s0], w[..., s0:]
        o = torch.matmul(wp, cache.vp[li].to(x.dtype)).transpose(1, 2)
        wg = wg.transpose(1, 2).reshape(bn, h, 1, g_len)
        o = o.reshape(bn, h, d) + torch.matmul(
            wg, cache.vg[li].to(x.dtype))[:, :, 0]
        x = x + nn.linear(blk["attn"]["proj"], o.reshape(bn, h * d))
        x = x + _mlp(cfg, blk["mlp"], nn.layer_norm(blk["ln2"], x))
    return nn.layer_norm(params["ln_f"], x)


def trunk_decode_step_split_anc(params: Params, cfg: GPTConfig,
                                x: torch.Tensor, cache: SplitCache, slot: int,
                                keep_p: torch.Tensor, nb: int,
                                amap: torch.Tensor) -> torch.Tensor:
    """One beam decode step over a SplitCache in the ancestry layout, with
    no physical reorder: ``amap`` (B, nb, G) maps (logical beam, gen slot)
    to the physical beam of its row whose cache holds that slot's K/V.
    Scores are computed against every physical beam of the row and the
    ancestor's is selected; the value product applies the same selection to
    the probabilities. The current step writes physical beam == logical
    beam, so the map at ``slot`` is taken as identity here (the decode
    loop updates the map after selection). Writes the new K/V slot into
    ``cache.kg/vg`` in place, as ``trunk_decode_step_split`` does. Returns
    hidden (BN, C) after ln_f."""
    bn = x.shape[0]
    b = bn // nb
    h, d = cfg.heads, cfg.head_dim
    g_len, s0 = cache.kg.shape[4], cache.kp.shape[3]
    pbias, gbias = _split_biases(keep_p, g_len, slot)
    scale = 1.0 / math.sqrt(d)
    beams = torch.arange(nb, device=x.device, dtype=amap.dtype)
    at_slot = torch.arange(g_len, device=x.device) == slot
    amap_eff = torch.where(at_slot, beams[None, :, None], amap)  # (B, nb, G)
    pick = amap_eff[:, None, :, None, :].expand(b, h, nb, 1, g_len)
    onehot = (amap_eff[:, :, None, :] == beams[None, None, :, None]
              ).to(x.dtype)[:, None]                    # (B, 1, nb_log, nb_phys, G)
    for li, blk in enumerate(params["blocks"]):
        q, k, v = nn.linear(blk["attn"]["qkv"], nn.layer_norm(blk["ln1"], x)
                            ).chunk(3, dim=-1)
        heads_major = lambda t: t.reshape(b, nb, h, d).transpose(1, 2)
        cache.kg[li, :, :, :, slot] = heads_major(k)
        cache.vg[li, :, :, :, slot] = heads_major(v)
        qf = heads_major(q).float()                     # (B, H, nb, D)
        lp = torch.matmul(qf, cache.kp[li].float().transpose(-1, -2)) * scale
        kg = cache.kg[li].float().reshape(b, h, nb * g_len, d)
        s_all = (torch.matmul(qf, kg.transpose(-1, -2)) * scale
                 ).reshape(b, h, nb, nb, g_len)
        lg = torch.gather(s_all, 3, pick)[:, :, :, 0]   # the ancestor's score
        logits = torch.cat([lp + pbias, lg + gbias], dim=-1)   # (B,H,nb,S0+G)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        wp, wg = w[..., :s0], w[..., s0:]
        wgm = (wg[:, :, :, None, :] * onehot).reshape(b, h, nb, nb * g_len)
        vg = cache.vg[li].to(x.dtype).reshape(b, h, nb * g_len, d)
        o = (torch.matmul(wp, cache.vp[li].to(x.dtype))
             + torch.matmul(wgm, vg))                   # (B, H, nb, D)
        o = o.transpose(1, 2).reshape(bn, h * d)
        x = x + nn.linear(blk["attn"]["proj"], o)
        x = x + _mlp(cfg, blk["mlp"], nn.layer_norm(blk["ln2"], x))
    return nn.layer_norm(params["ln_f"], x)


def get_conditioning(params: Params, cfg: GPTConfig, mel: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """mel (B, T, n_mels) + lengths → conds (B, 32, model_dim): the
    conformer + perceiver (v1.5), or for ``condition_type == "perceiver"``
    the v1.0 legacy encoder + perceiver, which take no lengths."""
    if cfg.condition_type == "perceiver":
        x = legacy_cond.forward(params["cond_encoder"], mel, heads=cfg.heads)
        return perceiver.forward(params["perceiver"], x, mask=None,
                                 heads=cfg.cond_attention_heads)
    x, keep = conformer.forward(params["cond_encoder"], mel, lengths,
                                heads=cfg.cond_attention_heads)
    ones = torch.ones((keep.shape[0], cfg.condition_num_latent),
                      dtype=torch.bool, device=keep.device)
    return perceiver.forward(params["perceiver"], x,
                             torch.cat([ones, keep], dim=1),
                             heads=cfg.cond_attention_heads)


def mel_logits_from_hidden(params: Params, h: torch.Tensor) -> torch.Tensor:
    """final_norm + mel head."""
    return nn.linear(params["mel_head"], nn.layer_norm(params["final_norm"], h))


def _framed_mel(cfg: GPTConfig, codes: torch.Tensor,
                code_lens: torch.Tensor) -> torch.Tensor:
    """[start, codes (stop beyond code_len+1), stop]."""
    mpos = torch.arange(codes.shape[1], device=codes.device)[None, :]
    mel = torch.where(mpos < (code_lens + 1)[:, None], codes,
                      cfg.stop_mel_token)
    b = codes.shape[0]
    start = torch.full((b, 1), cfg.start_mel_token, dtype=mel.dtype,
                       device=mel.device)
    stop = torch.full((b, 1), cfg.stop_mel_token, dtype=mel.dtype,
                      device=mel.device)
    return torch.cat([start, mel, stop], dim=1)


def build_latent_inputs(params: Params, cfg: GPTConfig, conds: torch.Tensor,
                        text_ids: torch.Tensor, text_lens: torch.Tensor,
                        codes: torch.Tensor, code_lens: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unbucketed latent-pass inputs: (emb (B, 32+Lt+2+M+2, C), mel ids)."""
    b, lt = text_ids.shape
    tpos = torch.arange(lt, device=text_ids.device)[None, :]
    text = torch.where(tpos < text_lens[:, None], text_ids, cfg.stop_text_token)
    text = torch.cat([torch.full((b, 1), cfg.start_text_token, dtype=text.dtype,
                                 device=text.device), text,
                      torch.full((b, 1), cfg.stop_text_token, dtype=text.dtype,
                                 device=text.device)], dim=1)
    mel = _framed_mel(cfg, codes, code_lens)
    text_emb = (nn.embedding(params["text_emb"], text)
                + params["text_pos"]["w"][None, :text.shape[1]])
    mel_emb = (nn.embedding(params["mel_emb"], mel)
               + params["mel_pos"]["w"][None, :mel.shape[1]])
    emb = torch.cat([conds.to(text_emb.dtype), text_emb, mel_emb], dim=1)
    return emb, mel


def forward_latent_bucketed(params: Params, cfg: GPTConfig, conds: torch.Tensor,
                            text_ids: torch.Tensor, text_lens: torch.Tensor,
                            codes: torch.Tensor, code_lens: torch.Tensor
                            ) -> torch.Tensor:
    """Teacher-forced latent pass at padded bucket widths, equal to the
    exact-shape computation for positions < code_len per row: text is framed
    [start, tokens, stop] and right-aligned in its block with the pads
    masked out of attention; mel padding beyond code_len+1 becomes stop
    tokens. Returns (B, M_pad, C)."""
    b, lt = text_ids.shape
    dev = text_ids.device
    cond_n = conds.shape[1]
    width = lt + 2
    pad = width - (text_lens + 2)
    rel = torch.arange(width, device=dev)[None, :] - pad[:, None]
    framed_len = text_lens + 2
    keep_text = rel >= 0
    gathered = torch.gather(text_ids, 1, torch.clamp(rel - 1, 0, lt - 1))
    framed = torch.where(rel == 0, cfg.start_text_token,
                         torch.where(rel == framed_len[:, None] - 1,
                                     cfg.stop_text_token, gathered))
    framed = torch.where(keep_text, framed, cfg.stop_text_token)
    text_pos = torch.clamp(rel, 0, cfg.max_text_seq - 1)
    text_emb = (nn.embedding(params["text_emb"], framed)
                + params["text_pos"]["w"][text_pos])
    text_emb = torch.where(keep_text[..., None], text_emb,
                           torch.zeros((), dtype=text_emb.dtype, device=dev))
    mel = _framed_mel(cfg, codes, code_lens)
    mel_emb = (nn.embedding(params["mel_emb"], mel)
               + params["mel_pos"]["w"][None, :mel.shape[1]])
    emb = torch.cat([conds.to(text_emb.dtype), text_emb, mel_emb], dim=1)
    keep = torch.cat([torch.ones((b, cond_n), dtype=torch.bool, device=dev),
                      keep_text,
                      torch.ones((b, mel.shape[1]), dtype=torch.bool,
                                 device=dev)], dim=1)
    h = trunk_forward(params, cfg, emb, pad_keep=keep)
    enc = nn.layer_norm(params["final_norm"], h[:, cond_n:])
    return enc[:, -mel.shape[1]:][:, :-2]
