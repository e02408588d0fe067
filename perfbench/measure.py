"""Arithmetic the metric readers share: over the window's calls, and over
the traced stretch."""
from __future__ import annotations

from typing import Optional

from perfbench import roofline


def ok(data):
    return [r for r in data.records if r["error"] is None]


def summed_rtf(data) -> Optional[float]:
    calls = ok(data)
    audio = sum(r["audio_s"] for r in calls)
    return sum(r["t1"] - r["t0"] for r in calls) / audio if audio else None


def audio_per_s(data) -> float:
    return sum(r["audio_s"] for r in ok(data)) / data.window_s


def decode_ms_per_step(data) -> Optional[float]:
    calls = ok(data)
    steps = sum(r["steps"] for r in calls)
    return 1e3 * sum(r["gpt_gen"] for r in calls) / steps if steps else None


def vocoder_s_per_audio_s(data) -> Optional[float]:
    calls = ok(data)
    audio = sum(r["audio_s"] for r in calls)
    return sum(r["bigvgan"] for r in calls) / audio if audio else None


def idle_share(data) -> Optional[float]:
    """Per cent of the traced stretch in which the device ran nothing."""
    t = data.trace
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def k2_roofline(data) -> Optional[float]:
    """Per cent: K2's least time over its launches' shapes, over its
    device time in the trace."""
    t = data.trace
    if not t or not data.k2_launches:
        return None
    dev = sum(v for k, v in t["device_s_by_name"].items()
              if "resblock_kernel" in k)
    if dev <= 0:
        return None
    bound = sum(roofline.k2_bound_s(*l) for l in data.k2_launches)
    return 100.0 * bound / dev


def mfu(data) -> Optional[float]:
    """Per cent of the dtype's peak: the model FLOPs of the window's
    served calls over its wall."""
    flops = 0.0
    for r in ok(data):
        tokens = [sum(not c.isspace() for c in t) for t in r["texts"]]
        flops += roofline.model_flops(data.cell.config, tokens, r["beams"],
                                      r["steps"], r["frames"])
    if flops <= 0:
        return None
    return 100.0 * flops / (data.window_s * roofline.PEAK_OPS[data.dtype])
