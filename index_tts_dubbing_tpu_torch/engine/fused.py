"""The fused route on the device: decode → silence trim → latent pass, then
(the one-program flavour) a static window plan over the stream and the
windowed C-major vocoder.

Counterpart of the JAX package's ``engine/fused.py``. JAX compiles each
flavour into one program; here they are eager ops with no host round-trip
between the stages:

- ``synthesize_fused_lat`` ends at the latent pass (the "fused+stream"
  flavour: the engine reads the lengths once and vocodes through
  ``WindowedVocoder.stream_device``);
- ``vocode_fused`` is the rest of JAX's ``synthesize_fused``: the window
  plan over the virtual stream, the windows on the kernels the vocoder's
  switches pick (K1, K2), the exact edge patches and the int16 emission,
  all at shapes set by (batch, steps) and the window count alone.
  ``synthesize_fused`` of JAX is the two in turn, which
  ``IndexTTS.synthesize_fused`` runs.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from index_tts_dubbing_tpu_torch.config import GPTConfig
from index_tts_dubbing_tpu_torch.engine import decode as decode_mod
from index_tts_dubbing_tpu_torch.engine.vocoder import (WindowedVocoder,
                                                       exact_span)
from index_tts_dubbing_tpu_torch.models import gpt as gpt_model
from index_tts_dubbing_tpu_torch.utils import profiling


class FusedLatResult(NamedTuple):
    codes: torch.Tensor          # (B, steps) raw generated codes (pre-trim)
    gen_lengths: torch.Tensor    # (B,) pre-trim lengths
    lens: torch.Tensor           # (B,) post-trim latent frames per row
    lat: torch.Tensor            # (B, steps, C) latent-pass output
    steps: int                   # decode steps run (GenerateResult.steps)


class FusedResult(NamedTuple):
    wav: torch.Tensor            # (num_windows·window·upsample,) float32;
                                 # the valid prefix is stream_frames·upsample
    wav_i16: torch.Tensor        # the same samples as int16, clip(wav·32767)
                                 # truncated toward zero, made on the device
    stream_frames: torch.Tensor  # 0-d: total latent frames after the trim
    codes: torch.Tensor          # (B, steps) raw generated codes (pre-trim)
    gen_lengths: torch.Tensor    # (B,) pre-trim lengths
    lens: torch.Tensor           # (B,) post-trim latent frames per row
    lat: torch.Tensor            # (B, steps, C): the short-stream fallback
                                 # re-vocodes from it
    steps: int                   # decode steps run


def synthesize_fused_lat(gpt_params: Dict[str, Any], gpt_cfg: GPTConfig,
                         sc: decode_mod.SamplingConfig, conds: torch.Tensor,
                         ids: torch.Tensor, pos: torch.Tensor,
                         seg: torch.Tensor, cond_idx: torch.Tensor,
                         text_ids: torch.Tensor, text_lens: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         live: Optional[torch.Tensor] = None,
                         *, num_beams: int = 1,
                         length_penalty: float = 0.0,
                         workspaces: Optional[decode_mod.BeamWorkspaces] = None
                         ) -> FusedLatResult:
    """Prefix arrays from ``prepare_prefix_host`` plus unframed text rows
    (B, L) and their lengths → codes, trimmed lengths and latents.
    ``num_beams > 1`` decodes by beam sampling (``sc.do_sample``) or beam
    search (over ``workspaces``, as ``decode._beam_decode`` takes them);
    otherwise by sampling or greedy."""
    from index_tts_dubbing_tpu_torch.engine.tts import (
        remove_long_silence_device)
    b = ids.shape[0]
    with profiling.span("decode.prefill", device=ids.device):
        emb, keep = decode_mod.build_prefix_emb(gpt_params, gpt_cfg, conds,
                                                ids, pos, seg, cond_idx)
    if num_beams > 1:
        res = decode_mod._beam_decode(gpt_params, gpt_cfg, sc, emb, keep,
                                      generator, num_beams, length_penalty,
                                      stochastic=sc.do_sample, live=live,
                                      workspaces=workspaces)
    else:
        res = decode_mod.generate(gpt_params, gpt_cfg, sc, emb, keep,
                                  generator, live=live)
    with profiling.span("latent", device=ids.device):
        codes, lens = remove_long_silence_device(res.codes,
                                                 gpt_cfg.stop_mel_token)
        if conds.shape[0] == 1 and b > 1:
            conds = conds.expand((b,) + conds.shape[1:])
        lat = gpt_model.forward_latent_bucketed(gpt_params, gpt_cfg, conds,
                                                text_ids, text_lens, codes,
                                                lens)
    return FusedLatResult(res.codes, res.lengths, lens, lat, res.steps)


def vocode_fused(voc: WindowedVocoder, res: FusedLatResult,
                 spk: torch.Tensor, num_windows: int) -> FusedResult:
    """Vocode the stream concat(lat[i, :lens[i]]) through a static plan of
    ``num_windows`` windows (JAX ``fused.py:169-235``). Windows past the
    stream are junk and their outputs lie past ``stream_frames·upsample``.
    JAX clamps out-of-range gathers by itself; every index here is clamped
    explicitly, so no gather leaves its tensor. The windows run on the
    vocoder's switches (``use_pallas``: K1, ``fuse_resblocks``: K2) in
    batches of at most ``voc.max_batch``; the first and last ``halo``
    frames are then overwritten by the exact route where ``stream_device``
    would (``edge_exact`` on a kernel route, JAX ``fused.py:206``)."""
    lat, lens = res.lat, res.lens.long()
    b, mb, c = lat.shape
    dev = lat.device
    window, halo, up = voc.window, voc.halo, voc.upsample
    full = window + 2 * halo
    p_total = b * mb
    t = lens.sum()
    bounds = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        lens.cumsum(0)])
    pos_s = torch.arange(p_total, device=dev)
    row = (torch.searchsorted(bounds, pos_s, right=True) - 1).clamp(0, b - 1)
    col = pos_s - bounds[row]
    # past the stream (pos >= t) col may pass mb: clamp into range
    flatmap = (row * mb + col).clamp(0, p_total - 1)
    wi = torch.arange(num_windows, device=dev)
    lo = torch.minimum((wi * window - halo).clamp_min(0),
                       (t - full).clamp_min(0))
    gidx = (lo[:, None] + torch.arange(full, device=dev)[None, :]).clamp(
        0, p_total - 1)
    idx = flatmap[gidx]                                  # (NW, full)
    flat = lat.reshape(p_total, c).to(voc.compute_dtype)
    # output start in each window; the tail of the last real window and the
    # junk windows reach past their window's output, where JAX reads fill
    # values: clamp (those samples lie past the stream)
    off = wi * window - lo
    oidx = (off[:, None] * up
            + torch.arange(window * up, device=dev)[None, :]).clamp(
                0, full * up - 1)
    wav = torch.empty((num_windows, window * up), dtype=torch.float32,
                      device=dev)
    with profiling.span("vocoder.plan", device=dev):
        for chunk in voc._plan_batches(list(range(num_windows))):
            s, e = chunk[0], chunk[-1] + 1
            wav_w = voc._vocode(flat[idx[s:e]], spk, exact=False).float()
            wav[s:e] = torch.gather(wav_w, 1, oidx[s:e])
    wav = wav.reshape(-1)

    if voc.edge_exact and voc._edge_approx():
        # stream-boundary patches of 2·halo frames through the exact route
        # (on the kernels' exact-edge mode where a kernel switch is on);
        # each keeps its boundary half (JAX fused.py:206-230)
        with exact_span(dev):
            pw = 2 * halo
            ar = torch.arange(pw, device=dev)
            lidx = flatmap[ar.clamp(max=p_total - 1)]
            ridx = flatmap[(t - pw + ar).clamp(0, p_total - 1)]
            ewav = voc._vocode(flat[torch.stack([lidx, ridx])], spk[:1],
                               exact=True).float()
            n_half = halo * up
            wav[:n_half] = ewav[0, :n_half]
            # dynamic_update_slice clamps its start so the update fits
            start = ((t - halo) * up).clamp(0, wav.numel() - n_half)
            wav[start + torch.arange(n_half, device=dev)] = ewav[1, n_half:]

    # the emission scaling on the device: float → int16 truncates toward
    # zero, as JAX's convert and numpy's astype do
    wav_i16 = (wav * 32767.0).clamp(-32767.0, 32767.0).to(torch.int16)
    return FusedResult(wav, wav_i16, t, res.codes, res.gen_lengths, res.lens,
                       lat, res.steps)
