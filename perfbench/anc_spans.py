"""What ``anc_attn_share.*`` reads: the share of the beam decode's steps
whose attention ran on kernel K3 in every layer of the trunk.

The port marks each ``decode.step`` span with the attribute ``anc_attn``:
the K3 launches the step made (an eager step) or holds (a CUDA graph's
replay), 0 where the attention took its plain route. A step ran wholly on
K3 where that count equals the configuration's layer count. The reader
takes the steps of the device-only traced stretch
(``spans.traced_requests``). K3 exists only on a card, so off one the
reader, like the other device readers (``graph_spans``), finds nothing to
read: it returns None where the run's trace shows no device busy (a run on
the CPU), and where no step carries the attribute (no step recorded, or a
port that does not mark its steps).
"""
from __future__ import annotations

from typing import Optional

from perfbench import spans


def anc_attn_share(data) -> Optional[float]:
    """Per cent of the marked ``decode.step`` spans with ``anc_attn`` equal
    to the trunk's layer count."""
    layers = data.cell.config.get("gpt", {}).get("layers")
    if not layers or not data.trace or data.trace["busy_s"] <= 0:
        return None
    reqs = spans.traced_requests(data)
    if reqs is None:
        return None
    marks = [s.attrs["anc_attn"] for r in reqs for s in r
             if s.name == "decode.step" and "anc_attn" in (s.attrs or {})]
    if not marks:
        return None
    return 100.0 * sum(m == layers for m in marks) / len(marks)
