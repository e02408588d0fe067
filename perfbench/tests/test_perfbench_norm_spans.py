"""``fused_norm_share`` (``perfbench/norm_spans.py`` and
``perfbench/metrics/fused_norm_share.{line,scene}.py``) on hand-built
recorded requests: every step on K4, none, a mix, a step with K4 in only
some layers; None where no step was recorded, no step carries the
``step_norm`` attribute (a port that does not mark its steps), the run's
trace shows no device busy (a run on the CPU, where K4 does not exist) or
the configuration names no layer count."""
from types import SimpleNamespace

import pytest

from index_tts_dubbing_tpu_torch.utils import profiling
from perfbench import harness, norm_spans
from perfbench.tests.conftest import ROOT

LAYERS = 20
FULL = 3 * LAYERS + 1       # K4's launches in a step of LAYERS layers


def _data(trace_calls: int = 1, card: bool = True, layers=LAYERS):
    """A traced run's data; off a ``card`` its trace shows no device busy."""
    config = {} if layers is None else {"gpt": {"layers": layers}}
    return SimpleNamespace(cell=SimpleNamespace(
        mix={"trace_calls": trace_calls}, config=config),
        trace={"busy_s": 0.25 if card else 0.0, "window_s": 1.0})


def _request(rid: int, marks) -> list:
    """A call whose ``decode.step`` spans carry ``marks`` as ``step_norm``
    (None: no attribute), beside a prefill and a done check."""
    def s(i, name, parent, attrs):
        return SimpleNamespace(id=rid + i, request=rid, name=name,
                               parent=None if parent is None else rid + parent,
                               t0=0.0, t1=0.0, device_ms=None, attrs=attrs)
    spans = [s(0, "request", None, {"graph_captures": 0}),
             s(1, "decode.prefill", 0, {})]
    for i, m in enumerate(marks):
        attrs = {"graph": 1, "anc_attn": LAYERS}
        if m is not None:
            attrs["step_norm"] = m
        spans.append(s(2 + i, "decode.step", 0, attrs))
    spans.append(s(2 + len(marks), "sync", 0, {"at": "done"}))
    return spans


@pytest.fixture
def recorded(monkeypatch):
    """``profiling.requests`` returning what a test puts in the list."""
    reqs: list = []
    monkeypatch.setattr(profiling, "requests", lambda: list(reqs))
    return reqs


@pytest.mark.parametrize("marks,share", [([FULL, FULL, FULL], 100.0),
                                         ([0, 0, 0], 0.0),
                                         ([0, FULL, FULL, FULL], 75.0),
                                         ([FULL, 2 * LAYERS, FULL, 1], 50.0)],
                         ids=["all", "none", "mix", "some_layers"])
def test_share_of_steps_on_k4(recorded, marks, share):
    recorded.append(_request(100, marks))
    assert norm_spans.fused_norm_share(_data()) == pytest.approx(share)


def test_the_layer_count_is_the_configurations(recorded):
    recorded.append(_request(100, [7, 7, FULL]))
    assert norm_spans.fused_norm_share(_data(layers=2)) == pytest.approx(
        100.0 * 2 / 3)


def test_only_the_device_only_stretch_counts(recorded):
    recorded += [_request(100, [0, 0]),             # an earlier run
                 _request(200, [FULL, FULL, FULL]),  # stretch 1
                 _request(300, [0, FULL]),
                 _request(400, [0, 0]),             # stretch 2
                 _request(500, [0, 0])]
    assert norm_spans.fused_norm_share(_data(2)) == pytest.approx(80.0)


@pytest.mark.parametrize("marks,card,layers",
                         [([], True, LAYERS), ([None, None], True, LAYERS),
                          ([0, 0], False, LAYERS), ([FULL, FULL], True, None)],
                         ids=["no_step", "unmarked", "off_a_card",
                              "no_layers"])
def test_nothing_to_read_reads_none(recorded, monkeypatch, marks, card,
                                    layers):
    data = _data(card=card, layers=layers)
    assert norm_spans.fused_norm_share(data) is None
    recorded.append(_request(100, marks))
    assert norm_spans.fused_norm_share(data) is None
    monkeypatch.delattr(profiling, "requests")
    assert norm_spans.fused_norm_share(data) is None


@pytest.mark.parametrize("name", ["fused_norm_share.line",
                                  "fused_norm_share.scene"])
def test_metric_files_read_through_the_helper(recorded, name):
    recorded.append(_request(100, [0, FULL, FULL, FULL]))
    assert harness.reader(ROOT, name)(_data()) == pytest.approx(75.0)
