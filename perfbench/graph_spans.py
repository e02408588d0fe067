"""What ``graph_step_share.*`` reads: the share of the decode's steps that
ran as the replay of a CUDA graph.

The port marks each ``decode.step`` span with the attribute ``graph``: 1
where the step was a graph's replay, 0 where it ran eagerly. The reader
takes the steps of the device-only traced stretch
(``spans.traced_requests``). A graph exists only on a card, so off one
the reader, like the other device readers (``measure.idle_share``), finds
nothing to read: it returns None where the run's trace shows no device
busy (a run on the CPU), and where no step carries the attribute (no step
recorded, or a port that does not mark its steps). On a card a run whose
steps all ran eagerly reads 0.
"""
from __future__ import annotations

from typing import Optional

from perfbench import spans


def graph_step_share(data) -> Optional[float]:
    """Per cent of the marked ``decode.step`` spans with ``graph`` 1."""
    if not data.trace or data.trace["busy_s"] <= 0:
        return None
    reqs = spans.traced_requests(data)
    if reqs is None:
        return None
    marks = [s.attrs["graph"] for r in reqs for s in r
             if s.name == "decode.step" and "graph" in (s.attrs or {})]
    return 100.0 * sum(marks) / len(marks) if marks else None
