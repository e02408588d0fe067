"""The profiled stretch of a traced run, reduced to what the per-layer
metrics read.

``torch.profiler`` (CPU and CUDA activity, CUPTI on the card) writes a
Chrome trace; ``reduce`` reads it: the device's busy time as the union of
its kernel, copy and set intervals, the device time summed by kernel name,
and the idle gaps between busy stretches, each named by the innermost host
op open at its middle.
"""
from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge intervals: the busy stretches, in order."""
    out: List[Tuple[float, float]] = []
    for start, stop in sorted(spans):
        if out and start <= out[-1][1]:
            if stop > out[-1][1]:
                out[-1] = (out[-1][0], stop)
        else:
            out.append((start, stop))
    return out


def _host_op_at(ops, starts, t: float) -> str:
    """The innermost host op open at ``t``: the latest-starting one whose
    interval holds it (a bounded look back)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 4000, -1), -1):
        a, b, name = ops[j]
        if b >= t:
            return name
    return "(no host op)"


def short(name: str, width: int = 100) -> str:
    """A kernel's name cut to ``width`` characters for the breakdown."""
    return name if len(name) <= width else name[: width - 3] + "..."


def reduce(trace_file: Path, top: int = 10) -> Dict:
    """From a Chrome trace: busy seconds, device seconds by name, the top
    device ops and the longest idle gaps by host op (seconds)."""
    events = json.loads(Path(trace_file).read_text())["traceEvents"]
    spans, by_name, ops = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_CATEGORIES:
            spans.append((start, start + dur))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + dur
        elif e.get("cat") in ("cpu_op", "user_annotation", "python_function"):
            ops.append((start, start + dur, e["name"]))
    merged = union(spans)
    busy = sum(b - a for a, b in merged)
    ops.sort()
    starts = [o[0] for o in ops]
    gaps: Dict[str, float] = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        name = _host_op_at(ops, starts, (a + b) / 2)
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    rank = lambda d: [(short(k), v) for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {
        "busy_s": busy * 1e-6,
        "device_s_by_name": {k: v * 1e-6 for k, v in by_name.items()},
        "device_ops": [[k, v * 1e-6] for k, v in rank(by_name)],
        "idle_gaps": [[k, v * 1e-6] for k, v in rank(gaps)],
    }
