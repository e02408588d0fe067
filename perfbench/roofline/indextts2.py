"""Operations of IndexTTS-2's work, from shapes: the FLOPs ``mfu.v2scene``
reads.

Multiply-adds counted twice each, per row at its own lengths (no credit
for the padding of a batch): the GPT's prefill over the conditioning rows
(32 latents and 2 duration rows), the framed text and the start code,
every decode step of every beam row, the latent pass over the prefix and
the served codes (``perfbench/roofline``'s GPT counts); the S2M DiT once
a step for each of the two guided rows at the row's frames, prompt
included (the input projection of ``[x, prompt, cond, style]``, the
condition's projection, per block q, k, v, the output projection, the
scores and values of bidirectional attention, the SwiGLU, the U-ViT skip
projections, the long skip, and the WaveNet head: its input linear, the
dilated convs, the res-skip convs, the residual projection, the final
linear and the output conv); and the vocoder's convolutions for every
generated frame served (``bigvgan_ops_per_frame``). Norms, modulations,
the time embeddings, activations, ``gpt_layer``, the length regulator, the
ODE's updates and the cached voice front end are left out.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

from perfbench.roofline import (bigvgan_ops_per_frame, gpt_decode_ops,
                                gpt_prefill_ops)

DURATION_ROWS = 2


def dit_forward_ops(cfg: Dict[str, Any], n: int) -> float:
    """One S2M DiT forward (with its WaveNet head) over one row of ``n``
    frames."""
    s = cfg["s2mel"]
    d, m, h = s["hidden_dim"], s["in_channels"], s["wavenet_hidden"]
    inter = cfg["assumed"]["s2mel_intermediate"]["value"]
    depth, layers, k = s["depth"], s["wavenet_layers"], s["wavenet_kernel"]
    ops = 2.0 * n * (d + 2 * m + s["style_dim"]) * d          # merge
    ops += 2.0 * n * s["content_dim"] * d                     # cond proj
    block = 2.0 * n * (4 * d * d + 3 * d * inter) + 2 * 2.0 * n * n * d
    receivers = sum(1 for i in range(depth) if i > depth // 2)
    ops += depth * block + receivers * 2.0 * n * 2 * d * d
    ops += 2.0 * n * (d + m) * d                              # long skip
    ops += 2.0 * n * d * h                                    # conv1
    ops += layers * 2.0 * n * h * 2 * h * k                   # in layers
    ops += (layers - 1) * 2.0 * n * h * 2 * h + 2.0 * n * h * h
    ops += 2.0 * n * d * h + 2.0 * n * h * h + 2.0 * n * h * m
    return ops


def call_flops(cfg: Dict[str, Any], text_tokens: Sequence[int],
               code_lens: Sequence[int], beams: int, steps: int,
               frames: Sequence[int], prompt_frames: int, nfe: int
               ) -> float:
    """One call: rows of ``text_tokens`` tokens, each decoded ``steps``
    steps by ``beams`` beams and served with ``code_lens`` codes; S2M rows
    of ``frames`` frames (prompt included) run guided for ``nfe`` steps,
    their generated frames vocoded."""
    g = cfg["gpt"]
    cond = g["condition_num_latent"] + DURATION_ROWS
    total = 0.0
    for n_text, n_codes in zip(text_tokens, code_lens):
        s0 = cond + n_text + 2 + 1
        total += gpt_prefill_ops(g, s0)
        total += beams * gpt_decode_ops(g, s0, steps)
        if n_codes:
            total += gpt_prefill_ops(g, cond + n_text + 2 + n_codes + 2) \
                - 2.0 * g["model_dim"] * g["number_mel_codes"]
    per_frame = bigvgan_ops_per_frame(cfg["vocoder"]["bigvgan"])
    for n in frames:
        total += 2 * nfe * dit_forward_ops(cfg, n)
        total += (n - prompt_frames) * per_frame
    return total
