"""The trace reduction: the union of device intervals, idle gaps by host
op, the idle share and K2's roofline share."""
import json

import pytest

from perfbench import measure, roofline, trace


def test_union_merges_overlaps_and_keeps_gaps():
    spans = [(5, 7), (0, 2), (1, 3), (6, 9), (10, 11)]
    assert trace.union(spans) == [(0, 3), (5, 9), (10, 11)]
    assert trace.union([]) == []


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce_reads_busy_ops_and_gaps(tmp_path):
    events = [
        _ev("kernel", "k_a", 0, 10), _ev("kernel", "k_b", 5, 10),
        _ev("gpu_memcpy", "copy", 30, 5), _ev("kernel", "k_a", 50, 20),
        _ev("cpu_op", "aten::mm", 14, 20),          # open over gap 15-30
        _ev("cpu_op", "aten::add", 34, 30),         # open over gap 35-50
        _ev("cpu_op", "aten::inner", 40, 5),        # inner, at gap middle
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
    ]
    f = tmp_path / "t.json"
    f.write_text(json.dumps({"traceEvents": events}))
    red = trace.reduce(f)
    assert red["busy_s"] == pytest.approx((15 + 5 + 20) * 1e-6)
    assert red["device_s_by_name"]["k_a"] == pytest.approx(30e-6)
    assert red["device_ops"][0] == ["k_a", pytest.approx(30e-6)]
    gaps = dict(red["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(15e-6)
    assert gaps["aten::inner"] == pytest.approx(15e-6)


def test_short_names():
    assert trace.short("a" * 100) == "a" * 100
    assert len(trace.short("b" * 300)) == 100


class _Data:
    def __init__(self, tr, launches=()):
        self.trace = tr
        self.k2_launches = list(launches)


def test_idle_share_and_k2_roofline():
    tr = {"busy_s": 1.0, "window_s": 4.0,
          "device_s_by_name": {"void resblock_kernel<float, 96>(...)": 0.02,
                               "other": 1.0}}
    assert measure.idle_share(_Data(tr)) == pytest.approx(75.0)
    assert measure.idle_share(_Data(dict(tr, busy_s=0.0))) is None
    assert measure.idle_share(_Data(None)) is None
    launch = (4, 96, 36864, 11, "float32")
    got = measure.k2_roofline(_Data(tr, [launch, launch]))
    assert got == pytest.approx(100 * 2 * roofline.k2_bound_s(*launch) / 0.02)
    assert measure.k2_roofline(_Data(tr)) is None
    no_k2 = dict(tr, device_s_by_name={"other": 1.0})
    assert measure.k2_roofline(_Data(no_k2, [launch])) is None
