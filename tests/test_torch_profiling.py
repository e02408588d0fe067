"""utils/profiling.py of the port against the JAX package's: ``Metrics`` and
``StageTimer`` compute the same numbers, ``trace(None)`` is a no-op,
``trace(dir)`` writes a Chrome trace on the CPU, and ``device_activity``
takes the union of the device's intervals from such a trace."""
import json
import time

import pytest
import torch

from index_tts_dubbing_tpu.utils import profiling as jprof
from index_tts_dubbing_tpu_torch.utils import profiling as pprof


@pytest.mark.parametrize("fields", [
    dict(decode_tokens=600, decode_seconds=12.5, vocoder_seconds=0.4,
         audio_seconds=25.6, wall_seconds=13.1, chips=1),
    dict(decode_tokens=0, decode_seconds=0.0, vocoder_seconds=0.0,
         audio_seconds=0.0, wall_seconds=0.0, chips=4),
])
def test_metrics_match_jax(fields):
    want, got = jprof.Metrics(**fields), pprof.Metrics(**fields)
    assert got.as_dict() == want.as_dict()
    for name in ("rtf", "decode_tokens_per_s", "vocoder_rtf",
                 "audio_seconds_per_s_per_chip"):
        assert getattr(got, name) == getattr(want, name)


def test_stage_timer_matches_jax():
    timers = (jprof.StageTimer(), pprof.StageTimer())
    for t in timers:
        for name in ("decode", "vocoder", "decode"):
            with t(name):
                time.sleep(0.002)
        with pytest.raises(KeyError):
            with t("failed"):
                raise KeyError("the span still counts")
    (jt, pt) = timers
    assert list(pt.totals) == list(jt.totals) == ["decode", "vocoder",
                                                  "failed"]
    assert pt.totals["decode"] >= 0.004 and pt.totals["failed"] > 0
    assert pt.report().split()[0].startswith("decode=")


def test_trace_none_is_a_no_op():
    with pprof.trace(None) as prof:
        torch.ones(3).sum()
    assert prof is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with pprof.trace(str(tmp_path / "t")) as prof:
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64)).sum()
    path = tmp_path / "t" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in e.key for e in prof.key_averages())


def test_device_activity_takes_the_union_of_device_intervals(tmp_path):
    """Overlapping and nested kernels count once; host ops and instant
    events do not count."""
    ev = lambda cat, name, ts, dur, ph="X": dict(cat=cat, name=name, ts=ts,
                                                 dur=dur, ph=ph)
    events = [ev("kernel", "a", 0, 10), ev("kernel", "b", 5, 10),
              ev("gpu_memcpy", "copy", 12, 2), ev("kernel", "a", 30, 5),
              ev("gpu_memset", "set", 40, 1), ev("cpu_op", "aten::mm", 0, 100),
              ev("kernel", "a", 50, 0, ph="i")]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    busy, by_name = pprof.device_activity(path)
    assert busy == 15 + 5 + 1
    assert by_name == {"a": 15.0, "b": 10.0, "copy": 2.0, "set": 1.0}
