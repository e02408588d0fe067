"""What the per-layer metrics of the engine's own spans read.

The port records spans only while a ``torch.profiler`` session runs
(``index_tts_dubbing_tpu_torch.utils.profiling``): in a traced run, the
warm-up and the window record nothing, and the harness's two traced
stretches of ``trace_calls`` calls each record one ``request`` a call. So
the run's last ``2 · trace_calls`` requests are those stretches, and the
first half of them is the stretch traced on the device alone, which is
what these metrics read. Each reader returns None where the program
records no spans (a port without the recorder) or no request was recorded.

A recorded span has ``name``, ``id``, ``parent`` (its parent's id, None for
a request), host seconds ``t0``/``t1`` and ``device_ms`` (None for a span
timed on the host alone).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional


def traced_requests(data) -> Optional[List[list]]:
    """The requests of the device-only traced stretch: each a list of its
    spans, the ``request`` first."""
    try:
        from index_tts_dubbing_tpu_torch.utils import profiling
    except ImportError:
        return None
    requests = getattr(profiling, "requests", None)
    if requests is None:
        return None
    reqs = [r for r in requests() if r and r[0].name == "request"]
    n = int(data.cell.mix.get("trace_calls", 1))
    return reqs[-2 * n:][:n] or None


def _host(s) -> float:
    return s.t1 - s.t0


def _read(data, fn: Callable[[List[list]], Optional[float]]
          ) -> Optional[float]:
    reqs = traced_requests(data)
    return None if reqs is None else fn(reqs)


def step_issue_ms(data) -> Optional[float]:
    """Mean host ms of a ``decode.step``, less its child ``sync`` spans."""
    def read(reqs):
        total, steps = 0.0, 0
        for spans in reqs:
            waits: Dict[int, float] = {}
            for s in spans:
                if s.name == "sync" and s.parent is not None:
                    waits[s.parent] = waits.get(s.parent, 0.0) + _host(s)
            for s in spans:
                if s.name == "decode.step":
                    total += _host(s) - waits.get(s.id, 0.0)
                    steps += 1
        return 1e3 * total / steps if steps else None
    return _read(data, read)


def host_wait_share(data) -> Optional[float]:
    """Per cent of the requests' host time spent in ``sync`` spans."""
    def read(reqs):
        wall = sum(_host(spans[0]) for spans in reqs)
        wait = sum(_host(s) for spans in reqs for s in spans
                   if s.name == "sync")
        return 100.0 * wait / wall if wall > 0 else None
    return _read(data, read)


def prefill_ms(data) -> Optional[float]:
    """Mean device ms of ``decode.prefill`` a call."""
    def read(reqs):
        ms = [s.device_ms for spans in reqs for s in spans
              if s.name == "decode.prefill" and s.device_ms is not None]
        return sum(ms) / len(reqs) if ms else None
    return _read(data, read)


def vocoder_exact_share(data) -> Optional[float]:
    """Per cent of the vocoder's device ms (``vocoder.plan`` and
    ``vocoder.exact``) that the exact route takes."""
    def read(reqs):
        ms = {"vocoder.plan": 0.0, "vocoder.exact": 0.0}
        for spans in reqs:
            for s in spans:
                if s.name in ms and s.device_ms is not None:
                    ms[s.name] += s.device_ms
        total = sum(ms.values())
        return 100.0 * ms["vocoder.exact"] / total if total > 0 else None
    return _read(data, read)
