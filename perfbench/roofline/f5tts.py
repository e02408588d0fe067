"""Operations of F5-TTS's work, from shapes: the FLOPs ``mfu.f5scene``
reads.

Multiply-adds counted twice each, per row at the row's own frames (no
credit for the padding of a batch): the DiT once a step for each of the
two guided rows (the input projection, the convolutional position
embedding, per block q, k, v, the output projection, the scores and values
of bidirectional attention and the feed-forward, and the output
projection), the text encoder once a call for both rows (ConvNeXt-V2's
depthwise and pointwise convs), and the vocoder's convolutions for every
generated frame served (``bigvgan_ops_per_frame``). Norms, the
modulations, activations, the time embedding and the ODE's updates are
left out.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

from perfbench.roofline import bigvgan_ops_per_frame


def dit_forward_ops(cfg: Dict[str, Any], n: int) -> float:
    """One DiT forward over one row of ``n`` frames."""
    a = cfg["arch"]
    d, t, m = a["dim"], a["text_dim"], cfg["mel"]["n_mels"]
    df = cfg["defaults"]
    inner = a["heads"] * df["dim_head"]
    ops = 2.0 * n * (2 * m + t) * d                            # input proj
    ops += 2 * 2.0 * n * d * (d // df["conv_pos_groups"]) \
        * df["conv_pos_kernel"]                                # conv pos
    block = 2.0 * n * (4 * d * inner + 2 * a["ff_mult"] * d * d) \
        + 2 * 2.0 * n * n * inner                              # attention
    return ops + a["depth"] * block + 2.0 * n * d * m


def text_ops(cfg: Dict[str, Any], n: int) -> float:
    """The text encoder over one row of ``n`` frames."""
    t = cfg["arch"]["text_dim"]
    return cfg["arch"]["conv_layers"] * 2.0 * n * (7 * t + 4 * t * t)


def call_flops(cfg: Dict[str, Any], frames: Sequence[int],
               prompt_frames: int, nfe: int) -> float:
    """One call: rows of ``frames`` frames each (prompt included), every
    one run guided for ``nfe`` steps, and its generated frames vocoded."""
    total = 0.0
    for n in frames:
        total += 2 * (nfe * dit_forward_ops(cfg, n) + text_ops(cfg, n))
        total += (n - prompt_frames) * bigvgan_ops_per_frame(
            cfg["vocoder"]["bigvgan"])
    return total
