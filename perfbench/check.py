"""The comparison that decides ``correct``.

After the window, a sample of the calls it finished, drawn from the seed
(the longest call and ``extra`` more), goes to the plain reference with
the prompt, the texts and the codes the program served. The numbers
compared, each with the limit that the cell's limits file states:

- ``code_gap``: the mixes decode by beam sampling (transformers' order:
  per-beam log-softmax, the repetition penalty over the ids the beam has
  seen, the fake prefix id 1 and the start code included, then
  temperature, top-k and top-p with at least two codes kept). Every served
  code was drawn from the kept set of its ancestor beam, whose history is
  the served row up to it. The reference reads the same scores along the
  served row, teacher-forced; at each position the boundary is the lowest
  score it keeps. ``code_gap`` is the widest gap by which a served code's
  score lies below that boundary (0 for a code inside). It covers the
  conditioning, the prefill, the cached beam decode and its reorders.
- ``wav_err``: over the compared calls, the largest relative L2 error of
  the int16 waveform the program returned against the reference's, which
  trims, runs the latent pass and vocodes the stream by the engine's plan
  on BigVGAN's exact route (a stream of another length reads infinite). It
  covers the trim, the latent pass, the speaker embedding, the windowed
  vocoder with K1, K2 and the edge patches, and the int16 emission.
- ``wav_ratio``: ``wav_err`` in units of ``wav_unit``, the error that
  TF32 convolutions and matmuls alone make in the reference's own vocoder
  on the same latents (int16 against int16). A random vocoder amplifies
  rounding by a factor that swings with the seed, and ``wav_err`` with it;
  the ratio divides it out. The cells compare ``code_gap`` and
  ``wav_ratio``; where TF32 does nothing (on the CPU) ``wav_unit`` is 0
  and ``wav_err`` stands in.

``readings(..., low=...)`` reads the same numbers for the control: the
reference in a lower precision put in the program's place, which at each
position serves the code that it puts first under sampling noise drawn
from the seed (Gumbel noise over its own kept set), and its own waveform.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference import Reference

REPETITION_PENALTY = 10.0   # the decoder's default, which the mixes keep
FAKE_PREFIX_ID = 1
MIN_KEEP = 2                # beam sampling's warpers keep at least two


def sample(records: Sequence[Dict[str, Any]], seed: int, extra: int
           ) -> List[int]:
    """Indices of the calls to compare: the longest (most audio) and
    ``extra`` more drawn from the seed."""
    ok = [i for i, r in enumerate(records) if r.get("error") is None]
    if not ok:
        return []
    chosen = {max(ok, key=lambda i: records[i]["audio_s"])}
    rest = [i for i in ok if i not in chosen]
    rng = np.random.default_rng([int(seed), 3])
    chosen.update(int(i) for i in rng.permutation(rest)[:extra])
    return sorted(chosen)


def scores(logits: torch.Tensor, codes: torch.Tensor, start_mel: int,
           temperature: float) -> torch.Tensor:
    """(n, V) beam-sampling scores before each served code: log-softmax,
    the repetition penalty over what the row held before the position (the
    fake prefix id, the start code, earlier codes), the temperature."""
    n, v = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    first = torch.full((v,), n, dtype=torch.long, device=logits.device)
    pos = torch.arange(n, device=logits.device)
    first = first.scatter_reduce(0, codes.long(), pos, reduce="amin")
    seen = first[None, :] < pos[:, None]
    seen[:, FAKE_PREFIX_ID] = True
    seen[:, start_mel] = True
    pen = torch.where(logp > 0, logp / REPETITION_PENALTY,
                      logp * REPETITION_PENALTY)
    return torch.where(seen, pen, logp) / temperature


def boundary(s: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """(n,) the lowest score that top-k, then top-p, keep in each row."""
    k = min(max(top_k, MIN_KEEP), s.shape[-1])
    topv = torch.topk(s, k, dim=-1).values
    if top_p >= 1.0:
        return topv[:, -1]
    probs = torch.softmax(topv, dim=-1)
    keep = (probs.cumsum(-1) - probs) <= top_p
    keep[:, :MIN_KEEP] = True
    return torch.gather(topv, 1, (keep.sum(-1) - 1)[:, None])[:, 0]


def served_length(codes: np.ndarray, stop: int) -> int:
    """Positions that were decided: up to and including the first stop."""
    stops = np.nonzero(codes == stop)[0]
    return int(stops[0]) + 1 if stops.size else codes.size


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return float("inf")
    want64 = want.astype(np.float64)
    den = max(float(np.linalg.norm(want64)), 1.0)
    return float(np.linalg.norm(got.astype(np.float64) - want64) / den)


def readings(ref: Reference, records: Sequence[Dict[str, Any]],
             idx: Sequence[int], cfg: Dict[str, Any], decode: Dict[str, Any],
             seed: int, low: Optional[Reference] = None) -> Dict[str, Any]:
    """The numbers over the sampled calls: for the program, or with ``low``
    for the control (``low`` in the program's place)."""
    g = cfg["gpt"]
    stop, start = g["stop_mel_token"], g["start_mel_token"]
    warp = lambda lg, c: scores(lg, c, start, decode["temperature"])
    noise = torch.Generator(device=ref.device)
    noise.manual_seed(int(seed) % 2**63)
    gap, err, ratio, unit, tokens = 0.0, 0.0, 0.0, 0.0, 0
    for i in idx:
        r = records[i]
        if r["codes"] is None:             # not the fused route: no codes
            err = ratio = float("inf")
            continue
        rows = list(zip(r["texts"], r["codes"]))
        for text, codes in rows:
            n = served_length(codes, stop)
            c = torch.as_tensor(codes[:n], device=ref.device).long()
            s = warp(ref.decode_logits(text, codes[:n]), c)
            if low is None:
                pick = c
            else:
                sl = warp(low.decode_logits(text, codes[:n]), c)
                kept = sl >= boundary(sl, decode["top_k"],
                                      decode["top_p"])[:, None]
                u = torch.rand(sl.shape, generator=noise,
                               device=ref.device).clamp_min(1e-30)
                z = torch.where(kept, sl - torch.log(-torch.log(u)),
                                float("-inf"))
                pick = z.argmax(-1)
            b = boundary(s, decode["top_k"], decode["top_p"])
            below = b - s.gather(1, pick[:, None])[:, 0]
            gap = max(gap, float(below.clamp_min(0).max()))
            tokens += n
        lat = ref.stream_latents(rows)
        want = ref.vocode_i16(lat)
        u = rel_err(ref.vocode_i16(lat, tf32=True), want)
        got = (r["wav"] if low is None
               else low.vocode_i16(low.stream_latents(rows)))
        e = rel_err(got, want)
        err = max(err, e)
        ratio = max(ratio, e / max(u, 1e-12))
        unit = max(unit, u)
    return {"code_gap": gap, "wav_err": err, "wav_ratio": ratio,
            "wav_unit": unit, "tokens": tokens, "calls": len(idx)}


def judge(read: Dict[str, Any], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit, and whether it holds."""
    out = {}
    for name, limit in limits.items():
        value = read[name]
        out[name] = {"value": value, "limit": limit,
                     "ok": bool(np.isfinite(value) and value <= limit)}
    return out
