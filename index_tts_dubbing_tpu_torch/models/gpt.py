"""UnifiedVoice: GPT-2 AR decoder over [cond(32) · text · mel-code] streams.

Counterpart of the JAX package's ``models/gpt.py``: the full-sequence
trunk, prefill and single-token decode over a KV cache that is allocated
once (``init_cache``) and written in place; the beam decode's split cache
(prefix once per row, generated region per beam) with its decode step
routed through an ancestry map (its attention a layer is kernel K3 on a
card, ``ops/anc_attention.py``, and the bias, residual, LayerNorm and GELU
work between its GEMMs kernel K4, ``ops/step_norm.py``); the mel head,
conditioning (and IndexTTS-2's emotion conditioner and conditioning rows,
``v2_conds``), and the latent pass, bucketed and unbucketed.
``params["blocks"]`` is a list of per-layer dicts
(``weights.from_jax_params`` unstacks the JAX package's stacked layout).
Attention is plain matmul → mask → softmax → matmul with
float32 scores, as in the JAX trunk.

Under a mesh (parallel/mesh.py) every trunk function runs tensor-parallel
over the ``model`` axis, Megatron-style: this rank's heads and MLP slice,
``copy_to_model`` before the qkv and fc projections, ``reduce_from_model``
after the attention and MLP ``proj`` products (the replicated bias added
once, after it), and a vocabulary-sharded head gathers its logits. Without
one each collective is the identity. ``forward_train`` gives the two
training cross-entropies.

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
from index_tts_dubbing_tpu_torch.ops.anc_attention import Slot, anc_attention
from index_tts_dubbing_tpu_torch.ops.step_norm import add_layer_norm, bias_gelu
from index_tts_dubbing_tpu_torch.parallel import mesh as tp

Params = Dict[str, Any]
_NEG = -1e30


def _tanh_gelu(cfg: GPTConfig) -> bool:
    return "tanh" in cfg.activation or cfg.activation == "gelu_new"


def _act(cfg: GPTConfig, x: torch.Tensor) -> torch.Tensor:
    return nn.gelu_tanh(x) if _tanh_gelu(cfg) else nn.gelu_exact(x)


def local_heads(cfg: GPTConfig) -> int:
    """Attention heads held by this rank: ``heads / model`` under a mesh."""
    return cfg.heads // tp.model_size()


def _row_linear(lin: Params, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel linear (input dimension sharded over ``model``): the
    partial products summed over the axis, then the replicated bias once."""
    if tp.model_size() == 1:
        return nn.linear(lin, x)
    y = tp.reduce_from_model(nn.linear(lin, x, bias=False))
    return y + lin["b"].to(y.dtype) if "b" in lin else y


def _mlp(cfg: GPTConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return _row_linear(p["proj"],
                       _act(cfg, nn.linear(p["fc"], tp.copy_to_model(x))))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor, scale: float) -> torch.Tensor:
    """(B,H,Tq,D) × (B,H,Tk,D) with an additive float32 bias."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits + bias, dim=-1).to(v.dtype)
    return torch.matmul(w, v)


def _qkv_linear(blk: Params, x: torch.Tensor) -> torch.Tensor:
    """The column-parallel qkv projection of ln1(x): (..., 3·H·D), q, k and
    v each over this rank's heads."""
    return nn.linear(blk["attn"]["qkv"],
                     tp.copy_to_model(nn.layer_norm(blk["ln1"], x)))


def _qkv(cfg: GPTConfig, blk: Params, x: torch.Tensor):
    return (nn.split_heads(t, local_heads(cfg))
            for t in _qkv_linear(blk, x).chunk(3, dim=-1))


def _block_out(cfg: GPTConfig, blk: Params, x: torch.Tensor,
               o: torch.Tensor) -> torch.Tensor:
    x = x + _row_linear(blk["attn"]["proj"], nn.merge_heads(o))
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
    shape = (cfg.layers, batch, local_heads(cfg), max_len, cfg.head_dim)
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
    attention time; only the generated region exists per beam, and no row
    of it moves when beams switch ancestry (an ancestry map routes it)."""
    kp: torch.Tensor  # (L, B, H, S0, D) prefix keys, frozen after prefill
    vp: torch.Tensor  # (L, B, H, S0, D)
    kg: torch.Tensor  # (L, B, H, nb, G, D)
    vg: torch.Tensor


def init_gen_cache_anc(cfg: GPTConfig, b: int, nb: int, gen_len: int, dtype,
                       device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gen-region cache in the heads-major ancestry layout
    (L, B, H, nb, G, D): a row's nb beams of one head are one contiguous
    (nb·G, D) block, so attention over every physical beam is one matmul."""
    shape = (cfg.layers, b, local_heads(cfg), nb, gen_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def trunk_decode_step_split_anc(params: Params, cfg: GPTConfig,
                                x: torch.Tensor, cache: SplitCache, slot: Slot,
                                keep_p: torch.Tensor, nb: int,
                                amap: torch.Tensor) -> torch.Tensor:
    """One beam decode step over a SplitCache in the ancestry layout, with
    no physical reorder. x (BN, C) current-token embeddings; ``slot`` the
    gen slot this step writes (attention covers gen slots <= slot); keep_p
    (B, S0) prefix validity, shared by a row's beams; ``amap`` (B, nb, G)
    maps (logical beam, gen slot) to the physical beam of its row whose
    cache holds that slot's K/V. The current step writes physical beam ==
    logical beam, so the map at ``slot`` is taken as identity here (the
    decode loop updates the map after selection). Each layer's attention is
    ``ops/anc_attention.anc_attention``: kernel K3 on a card, its plain
    version on the CPU. The JAX step returns an updated copy of the cache;
    this one writes the new K/V slot into ``cache.kg/vg`` in place, which
    saves a copy of the gen region per layer. ``slot`` may be a 0-d device
    tensor: the step then reads no host value. Returns hidden (BN, C)
    after ln_f.

    Between the GEMMs a layer runs three ``ops/step_norm`` calls (kernel
    K4 on a card, its plain version on the CPU): the residual add of the
    attention's projection with its bias and ln2, the fc bias with the
    activation, the residual add of the MLP's projection with its bias and
    the next layer's ln1 (``ln_f`` after the last); layer 0's ln1 is one
    more. Under a mesh the row-parallel products are reduced before K4
    adds their bias, once, as ``_row_linear`` does; the fc is
    column-parallel, so ``bias_gelu`` takes each rank's shard with its own
    slice of the bias."""
    blocks = params["blocks"]
    erf = not _tanh_gelu(cfg)
    x, h = add_layer_norm(x, None, None, blocks[0]["ln1"])
    for li, blk in enumerate(blocks):
        attn, mlp = blk["attn"], blk["mlp"]
        o = anc_attention(nn.linear(attn["qkv"], tp.copy_to_model(h)),
                          cache.kp[li], cache.vp[li], cache.kg[li],
                          cache.vg[li], slot, keep_p, amap, nb)
        x, h = add_layer_norm(
            x, tp.reduce_from_model(nn.linear(attn["proj"], o, bias=False)),
            attn["proj"].get("b"), blk["ln2"])
        a = bias_gelu(nn.linear(mlp["fc"], tp.copy_to_model(h), bias=False),
                      mlp["fc"].get("b"), erf)
        x, h = add_layer_norm(
            x, tp.reduce_from_model(nn.linear(mlp["proj"], a, bias=False)),
            mlp["proj"].get("b"),
            blocks[li + 1]["ln1"] if li + 1 < len(blocks)
            else params["ln_f"])
    return h


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


def get_emo_conditioning(params: Params, feats: torch.Tensor,
                         lengths: torch.Tensor, heads: int) -> torch.Tensor:
    """IndexTTS-2's emotion conditioner (``model_v2.py``
    ``get_emo_conditioning``): features (B, T, 1024) → the conformer
    ``emo_encoder`` → the one-latent perceiver ``emo_perceiver`` →
    (B, emo_dim)."""
    x, keep = conformer.forward(params["emo_encoder"], feats, lengths,
                                heads=heads)
    ones = torch.ones((keep.shape[0], 1), dtype=torch.bool,
                      device=keep.device)
    return perceiver.forward(params["emo_perceiver"], x,
                             torch.cat([ones, keep], dim=1), heads=heads)[:, 0]


def emotion_vector(params: Params, feats: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """The emotion vector (1, model_dim): the emotion conditioner of the
    features (1, T, 1024) through ``emovec_layer`` then ``emo_layer``.
    With no emotion prompt IndexTTS-2's ``merge_emovec`` blends the
    speaker prompt's vector with itself at ``emo_alpha`` 1, which is this
    vector."""
    lens = torch.tensor([feats.shape[1]], device=feats.device)
    e = get_emo_conditioning(params, feats, lens, heads)
    return nn.linear(params["emo_layer"], nn.linear(params["emovec_layer"], e))


def v2_conds(params: Params, spk_latents: torch.Tensor,
             emo_vec: torch.Tensor) -> torch.Tensor:
    """IndexTTS-2's conditioning rows (``inference_speech``): the speaker
    latents plus the emotion vector, then the duration embedding's rows 1
    and 0 (``speed_emb``, free duration) → (1, latents + 2, model_dim)."""
    speed = params["speed_emb"]["w"]
    return torch.cat([spk_latents + emo_vec[:, None].to(spk_latents.dtype),
                      speed[1][None, None].to(spk_latents.dtype),
                      speed[0][None, None].to(spk_latents.dtype)], dim=1)


def _vocab_head(lin: Params, x: torch.Tensor, vocab: int) -> torch.Tensor:
    """An output head; one whose vocabulary is sharded over ``model`` (its
    width below ``vocab``) gathers its logits over the axis."""
    if (lin["w_q"] if "w_q" in lin else lin["w"]).shape[-1] == vocab:
        return nn.linear(lin, x)
    return tp.gather_from_model(nn.linear(lin, tp.copy_to_model(x)))


def mel_logits_from_hidden(params: Params, h: torch.Tensor) -> torch.Tensor:
    """final_norm + mel head."""
    return _vocab_head(params["mel_head"],
                       nn.layer_norm(params["final_norm"], h),
                       params["mel_emb"]["w"].shape[0])


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


def forward_latent(params: Params, cfg: GPTConfig, conds: torch.Tensor,
                   text_ids: torch.Tensor, text_lens: torch.Tensor,
                   codes: torch.Tensor, code_lens: torch.Tensor
                   ) -> torch.Tensor:
    """Teacher-forced latent pass at the inputs' own widths (no bucket
    masking): mel latents (B, M, C) over the padded code stream; positions
    past a row's code_len belong to stop tokens."""
    emb, mel = build_latent_inputs(params, cfg, conds, text_ids, text_lens,
                                   codes, code_lens)
    h = trunk_forward(params, cfg, emb)
    enc = nn.layer_norm(params["final_norm"], h[:, conds.shape[1]:])
    return enc[:, -mel.shape[1]:][:, :-2]


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


def forward_train(params: Params, cfg: GPTConfig, mel_cond: torch.Tensor,
                  cond_lens: torch.Tensor, text_ids: torch.Tensor,
                  text_lens: torch.Tensor, codes: torch.Tensor,
                  code_lens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (loss_text, loss_mel), the cross-entropies of the
    two streams against their inputs shifted left and framed with the stop
    token; each the mean over every position, pads included, with a float32
    log-softmax."""
    conds = get_conditioning(params, cfg, mel_cond, cond_lens)
    emb, _ = build_latent_inputs(params, cfg, conds, text_ids, text_lens,
                                 codes, code_lens)
    h = trunk_forward(params, cfg, emb)
    enc = nn.layer_norm(params["final_norm"], h[:, conds.shape[1]:])
    lt = text_ids.shape[1] + 2
    text_logits = _vocab_head(params["text_head"], enc[:, :lt],
                              params["text_emb"]["w"].shape[0])
    mel_logits = _vocab_head(params["mel_head"], enc[:, lt:],
                             params["mel_emb"]["w"].shape[0])

    def shifted(ids, lens, keep_extra, stop):
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        x = torch.where(pos < (lens + keep_extra)[:, None], ids, stop)
        return torch.cat([x, torch.full((x.shape[0], 2), stop, dtype=x.dtype,
                                        device=x.device)], dim=1)

    def ce(logits, tgt):
        lp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(lp, -1, tgt[..., None].long()).mean()

    text_tgt = shifted(text_ids, text_lens, 0, cfg.stop_text_token)
    mel_tgt = shifted(codes, code_lens, 1, cfg.stop_mel_token)
    return ce(text_logits, text_tgt), ce(mel_logits, mel_tgt)
