"""Profiling & metrics utilities.

Counterpart of the JAX package's ``utils/profiling.py``:
- ``StageTimer``: accumulating wall-clock spans per stage;
- ``trace``: a ``torch.profiler`` trace context (CPU and CUDA activities)
  that writes a Chrome trace under ``log_dir``; ``device_activity`` reads
  the device's busy time and its kernels out of such a trace;
- ``Metrics``: audio-seconds/s/card, decode tokens/s, vocoder RTF counters.
"""
from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import torch


@dataclass
class Metrics:
    decode_tokens: int = 0
    decode_seconds: float = 0.0
    vocoder_seconds: float = 0.0
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    chips: int = 1

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / max(self.decode_seconds, 1e-9)

    @property
    def vocoder_rtf(self) -> float:
        return self.vocoder_seconds / max(self.audio_seconds, 1e-9)

    @property
    def rtf(self) -> float:
        return self.wall_seconds / max(self.audio_seconds, 1e-9)

    @property
    def audio_seconds_per_s_per_chip(self) -> float:
        return self.audio_seconds / max(self.wall_seconds, 1e-9) / self.chips

    def as_dict(self) -> Dict[str, float]:
        return {
            "rtf": self.rtf,
            "decode_tokens_per_s": self.decode_tokens_per_s,
            "vocoder_rtf": self.vocoder_rtf,
            "audio_seconds_per_s_per_chip": self.audio_seconds_per_s_per_chip,
        }


class StageTimer:
    """Accumulates wall-clock per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self) -> str:
        return " ".join(f"{k}={v:.2f}s" for k, v in self.totals.items())


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None
          ) -> Iterator[Optional[torch.profiler.profile]]:
    """``torch.profiler`` over the block (CPU activity, and CUDA activity
    where a card is present), written as a Chrome trace
    ``log_dir/trace.json`` when the block ends; yields the profiler (its
    ``events()`` and ``key_averages()`` stay readable after the block). A
    no-op yielding None for ``log_dir`` None."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


# Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_activity(trace_file) -> Tuple[float, Dict[str, float]]:
    """From a Chrome trace that ``trace`` wrote: (the union of the device's
    busy intervals, µs; device µs summed by kernel or copy name)."""
    events = json.loads(Path(trace_file).read_text())["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            start, dur = float(e["ts"]), float(e.get("dur", 0.0))
            spans.append((start, start + dur))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + dur
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy, by_name
