"""``graph_step_share`` (``perfbench/graph_spans.py`` and
``perfbench/metrics/graph_step_share.{line,scene}.py``) on hand-built recorded
requests: every step replayed, none, a mix; None where no step was
recorded, no step carries the ``graph`` attribute (a port that does not
mark its steps) or the run's trace shows no device busy (a run on the
CPU, where no graph exists)."""
from types import SimpleNamespace

import pytest

from index_tts_dubbing_tpu_torch.utils import profiling
from perfbench import graph_spans, harness
from perfbench.tests.conftest import ROOT


def _data(trace_calls: int = 1, card: bool = True):
    """A traced run's data; off a ``card`` its trace shows no device busy."""
    return SimpleNamespace(cell=SimpleNamespace(
        mix={"trace_calls": trace_calls}),
        trace={"busy_s": 0.25 if card else 0.0, "window_s": 1.0})


def _request(rid: int, marks) -> list:
    """A call whose ``decode.step`` spans carry ``marks`` (None: no
    attribute), beside a prefill and a done check."""
    def s(i, name, parent, attrs):
        return SimpleNamespace(id=rid + i, request=rid, name=name,
                               parent=None if parent is None else rid + parent,
                               t0=0.0, t1=0.0, device_ms=None, attrs=attrs)
    spans = [s(0, "request", None, {"graph_captures": 0}),
             s(1, "decode.prefill", 0, {})]
    for i, m in enumerate(marks):
        spans.append(s(2 + i, "decode.step", 0,
                       {} if m is None else {"graph": m}))
    spans.append(s(2 + len(marks), "sync", 0, {"at": "done"}))
    return spans


@pytest.fixture
def recorded(monkeypatch):
    """``profiling.requests`` returning what a test puts in the list."""
    reqs: list = []
    monkeypatch.setattr(profiling, "requests", lambda: list(reqs))
    return reqs


@pytest.mark.parametrize("marks,share", [([1, 1, 1], 100.0),
                                         ([0, 0, 0], 0.0),
                                         ([0, 1, 1, 1], 75.0)],
                         ids=["all", "none", "mix"])
def test_share_of_replayed_steps(recorded, marks, share):
    recorded.append(_request(100, marks))
    assert graph_spans.graph_step_share(_data()) == pytest.approx(share)


def test_only_the_device_only_stretch_counts(recorded):
    recorded += [_request(100, [0, 0]),          # an earlier run
                 _request(200, [1, 1, 1]),        # stretch 1
                 _request(300, [0, 1]),
                 _request(400, [0, 0]),           # stretch 2
                 _request(500, [0, 0])]
    assert graph_spans.graph_step_share(_data(2)) == pytest.approx(80.0)


@pytest.mark.parametrize("marks,card", [([], True), ([None, None], True),
                                        ([0, 0], False)],
                         ids=["no_step", "unmarked", "off_a_card"])
def test_nothing_to_read_reads_none(recorded, monkeypatch, marks, card):
    data = _data(card=card)
    assert graph_spans.graph_step_share(data) is None
    recorded.append(_request(100, marks))
    assert graph_spans.graph_step_share(data) is None
    monkeypatch.delattr(profiling, "requests")
    assert graph_spans.graph_step_share(data) is None


def test_metric_files_read_through_the_helper(recorded):
    recorded.append(_request(100, [0, 1]))
    read = harness.reader(ROOT, "graph_step_share.scene")
    assert read(_data()) == pytest.approx(50.0)


def test_line_file_reads_as_the_scene_file(recorded):
    recorded.append(_request(100, [0, 1, 1, 1]))
    assert harness.reader(ROOT, "graph_step_share.line")(_data()) == \
        harness.reader(ROOT, "graph_step_share.scene")(_data()) == \
        pytest.approx(75.0)
