"""What ``fused_norm_share.*`` reads: the share of the beam decode's steps
whose bias, residual, LayerNorm and GELU chains ran on kernel K4 in every
layer of the trunk.

The port marks each ``decode.step`` span with the attribute ``step_norm``:
the K4 launches the step made (an eager step) or holds (a CUDA graph's
replay), 0 where the chains took their plain route. A step ran wholly on
K4 where that count equals 3 × the configuration's layer count + 1: per
layer one launch after the attention (the residual add and ln2), one after
the fc GEMM (bias and GELU) and one after the MLP (the residual add and
the next layer's ln1, or ``ln_f``), and layer 0's ln1. The reader takes
the steps of the device-only traced stretch (``spans.traced_requests``).
K4 exists only on a card, so off one the reader, like the other device
readers (``anc_spans``, ``graph_spans``), finds nothing to read: it
returns None where the run's trace shows no device busy (a run on the
CPU), and where no step carries the attribute (no step recorded, or a port
that does not mark its steps).
"""
from __future__ import annotations

from typing import Optional

from perfbench import spans


def fused_norm_share(data) -> Optional[float]:
    """Per cent of the marked ``decode.step`` spans with ``step_norm``
    equal to 3 × the trunk's layer count + 1."""
    layers = data.cell.config.get("gpt", {}).get("layers")
    if not layers or not data.trace or data.trace["busy_s"] <= 0:
        return None
    reqs = spans.traced_requests(data)
    if reqs is None:
        return None
    marks = [s.attrs["step_norm"] for r in reqs for s in r
             if s.name == "decode.step" and "step_norm" in (s.attrs or {})]
    if not marks:
        return None
    return 100.0 * sum(m == 3 * layers + 1 for m in marks) / len(marks)
