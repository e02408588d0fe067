"""The readers of the engine's own spans (``perfbench/spans.py`` and the
eight ``perfbench/metrics/`` files that call it) on hand-built recorded
requests: what each computes, that only the device-only traced stretch
counts, and None where nothing was recorded."""
from types import SimpleNamespace

import pytest

from index_tts_dubbing_tpu_torch.utils import profiling
from perfbench import harness, spans
from perfbench.tests.conftest import ROOT

READERS = ("step_issue_ms", "host_wait_share", "prefill_ms",
           "vocoder_exact_share")


def _data(trace_calls: int):
    return SimpleNamespace(cell=SimpleNamespace(
        mix={"trace_calls": trace_calls}))


def _request(rid: int, scale: float = 1.0) -> list:
    """A call of 100 ms on the host: a 10 ms prefill (4 ms on the device),
    two 20 ms steps, the second holding a 5 ms done check, a 3 ms wait on
    the wav, and a vocoder of 6 ms of plan and 2 ms of exact route on the
    device."""
    def s(i, name, parent, t0, t1, device_ms=None):
        return SimpleNamespace(id=rid + i, request=rid, name=name,
                               parent=None if parent is None else rid + parent,
                               t0=scale * t0, t1=scale * t1,
                               device_ms=device_ms, attrs={})
    return [s(0, "request", None, 0.0, 0.100),
            s(1, "gpt_gen", 0, 0.0, 0.060),
            s(2, "decode.prefill", 1, 0.0, 0.010, 4.0),
            s(3, "decode.step", 1, 0.010, 0.030),
            s(4, "decode.step", 1, 0.030, 0.050),
            s(5, "sync", 4, 0.040, 0.045),
            s(6, "bigvgan", 0, 0.060, 0.100),
            s(7, "vocoder.plan", 6, 0.060, 0.070, 6.0),
            s(8, "vocoder.exact", 6, 0.070, 0.080, 2.0),
            s(9, "sync", 6, 0.090, 0.093)]


@pytest.fixture
def recorded(monkeypatch):
    """``profiling.requests`` returning what a test puts in the list."""
    reqs: list = []
    monkeypatch.setattr(profiling, "requests", lambda: list(reqs))
    return reqs


def test_readers_compute_from_the_spans(recorded):
    recorded += [_request(100), _request(200)]
    data = _data(1)
    # (20 + 20 - 5 ms) over two steps
    assert spans.step_issue_ms(data) == pytest.approx(17.5)
    assert spans.host_wait_share(data) == pytest.approx(8.0)
    assert spans.prefill_ms(data) == pytest.approx(4.0)
    assert spans.vocoder_exact_share(data) == pytest.approx(25.0)


def test_only_the_device_only_stretch_counts(recorded):
    """A run's two traced stretches are its last 2·trace_calls requests;
    the first half is read. Requests of an earlier run in the process, and
    the host-traced second stretch, are not."""
    recorded += [_request(100, 9.0)]                  # an earlier run
    recorded += [_request(200), _request(300)]        # stretch 1
    recorded += [_request(400, 3.0), _request(500, 3.0)]   # stretch 2
    assert spans.traced_requests(_data(2)) == recorded[1:3]
    assert spans.step_issue_ms(_data(2)) == pytest.approx(17.5)
    # a span that is not a request at the root is not a call
    recorded.append([SimpleNamespace(name="other")])
    assert spans.traced_requests(_data(2)) == recorded[1:3]


@pytest.mark.parametrize("name", READERS)
def test_nothing_recorded_reads_none(recorded, monkeypatch, name):
    data = _data(1)
    assert getattr(spans, name)(data) is None
    # a request with none of the spans the reader needs
    recorded.append([SimpleNamespace(id=1, name="request", parent=None,
                                     t0=0.0, t1=0.0, device_ms=None)])
    assert getattr(spans, name)(data) is None
    # a port without the recorder, as a parent commit may be
    monkeypatch.delattr(profiling, "requests")
    assert getattr(spans, name)(data) is None


@pytest.mark.parametrize("kind", ["line", "scene"])
@pytest.mark.parametrize("name", READERS)
def test_metric_files_read_through_the_helper(recorded, name, kind):
    recorded += [_request(100), _request(200)]
    read = harness.reader(ROOT, f"{name}.{kind}")
    assert read(_data(1)) == getattr(spans, name)(_data(1))
