"""Decode → silence trim → latent pass for one batch, on the device.

Counterpart of the JAX package's ``engine/fused.py:synthesize_fused_lat``
(the "fused+stream" route: the engine then vocodes the latents through
``WindowedVocoder.stream_device``). No host round-trip happens between the
stages; the caller reads the per-row lengths once to plan the vocoder.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from index_tts_dubbing_tpu_torch.config import GPTConfig
from index_tts_dubbing_tpu_torch.engine import decode as decode_mod
from index_tts_dubbing_tpu_torch.models import gpt as gpt_model


class FusedLatResult(NamedTuple):
    codes: torch.Tensor          # (B, steps) raw generated codes (pre-trim)
    gen_lengths: torch.Tensor    # (B,) pre-trim lengths
    lens: torch.Tensor           # (B,) post-trim latent frames per row
    lat: torch.Tensor            # (B, steps, C) latent-pass output
    steps: int                   # decode steps run (GenerateResult.steps)


def synthesize_fused_lat(gpt_params: Dict[str, Any], gpt_cfg: GPTConfig,
                         sc: decode_mod.SamplingConfig, conds: torch.Tensor,
                         ids: torch.Tensor, pos: torch.Tensor,
                         seg: torch.Tensor, cond_idx: torch.Tensor,
                         text_ids: torch.Tensor, text_lens: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         live: Optional[torch.Tensor] = None,
                         *, num_beams: int = 1,
                         length_penalty: float = 0.0) -> FusedLatResult:
    """Prefix arrays from ``prepare_prefix_host`` plus unframed text rows
    (B, L) and their lengths → codes, trimmed lengths and latents.
    ``num_beams > 1`` decodes by beam sampling (``sc.do_sample``) or beam
    search; otherwise by sampling or greedy."""
    from index_tts_dubbing_tpu_torch.engine.tts import (
        remove_long_silence_device)
    b = ids.shape[0]
    emb, keep = decode_mod.build_prefix_emb(gpt_params, gpt_cfg, conds, ids,
                                            pos, seg, cond_idx)
    if num_beams > 1:
        res = decode_mod._beam_decode(gpt_params, gpt_cfg, sc, emb, keep,
                                      generator, num_beams, length_penalty,
                                      stochastic=sc.do_sample, live=live)
    else:
        res = decode_mod.generate(gpt_params, gpt_cfg, sc, emb, keep,
                                  generator, live=live)
    codes, lens = remove_long_silence_device(res.codes, gpt_cfg.stop_mel_token)
    if conds.shape[0] == 1 and b > 1:
        conds = conds.expand((b,) + conds.shape[1:])
    lat = gpt_model.forward_latent_bucketed(gpt_params, gpt_cfg, conds,
                                            text_ids, text_lens, codes, lens)
    return FusedLatResult(res.codes, res.lengths, lens, lat, res.steps)
