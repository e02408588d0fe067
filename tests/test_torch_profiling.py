"""utils/profiling.py of the port: the engine's spans and their recorder,
``trace`` and ``device_activity``.

The spans run on the port's small engine on the CPU (the widths of
tests/test_torch_engine.py, random weights, the vocoder's window cut to 16
frames so a short stream still passes it): each public entry point once
with no profiler and once under a CPU ``torch.profiler``, the engine's
generator reset before each, so the two calls draw the same codes."""
import contextlib
import json
import os
import time

import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS, StageTimes
from index_tts_dubbing_tpu_torch.utils import audio
from index_tts_dubbing_tpu_torch.utils import profiling as pprof

GPT_SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=260,
                 max_text_tokens=130, number_text_tokens=120,
                 cond_output_size=32, cond_linear_units=64,
                 cond_attention_heads=4, cond_num_blocks=2)
BV_SMALL = dict(gpt_dim=64, upsample_initial_channel=128)
UPSAMPLE = int(np.prod(pconfig.BigVGANConfig(**BV_SMALL).upsample_rates))
CPU = [torch.profiler.ProfilerActivity.CPU]
SPAN_NAMES = {"request", "front", "cond", "speaker", "decode.prefill",
              "decode.step", "sync", "gpt_gen", "gpt_forward", "latent",
              "bigvgan", "vocoder.plan", "vocoder.exact"}
STAGES = ("gpt_gen", "gpt_forward", "bigvgan")

# (entry point, its arguments, the route, the decodes it runs, span names
# it must hold)
CASES = {
    "infer": ("infer", ("Hello there friend. The quick brown fox jumps.",),
              dict(max_text_tokens_per_sentence=20, max_mel_tokens=16),
              "staged", 3, {"gpt_forward", "latent", "vocoder.exact"}),
    # one short line: the static plan, then the exact re-vocode
    "infer_fast": ("infer_fast", ("Hello there friend.",),
                   dict(max_mel_tokens=24), "fused", 1,
                   {"latent", "vocoder.plan", "vocoder.exact"}),
    # one 125-token sentence passes the largest text bucket: staged
    "infer_fast-staged": ("infer_fast", ("a" * 125,),
                          dict(max_text_tokens_per_sentence=130,
                               max_mel_tokens=16), "staged", 1,
                          {"gpt_forward", "latent", "vocoder.exact"}),
    # a stream past one window: the plan and its edge patches
    "infer_batch": ("infer_batch", (["Hello there.", "The quick brown fox."],),
                    dict(max_mel_tokens=30), "fused", 1,
                    {"latent", "vocoder.plan", "vocoder.exact"}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case untraced, then traced: wavs, StageTimes, the recorded
    request and the user annotations of the exported Chrome trace."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("profiling")
    cfg = pconfig.EngineConfig(gpt=pconfig.GPTConfig(**GPT_SMALL),
                               bigvgan=pconfig.BigVGANConfig(**BV_SMALL))
    tts = IndexTTS(config=cfg, device="cpu", verbose_init=False, seed=0,
                   vocoder_window=16)
    prompt = tmp / "prompt.wav"
    rng = np.random.default_rng(1)
    audio.write_wav(prompt, (rng.standard_normal(24000) * 0.1
                             ).astype(np.float32), 24000)
    out = {}
    try:
        for name, (entry, args, kw, *_) in CASES.items():
            pprof.clear()
            call = lambda: getattr(tts, entry)(str(prompt), *args, **kw)
            run = {}
            with open(os.devnull, "w") as sink, \
                    contextlib.redirect_stdout(sink):
                tts._generator.manual_seed(0)
                run["wav_off"] = call()
                run["times_off"] = tts.last_times
                run["recorded_off"] = len(pprof.requests())
                with torch.profiler.profile(activities=CPU) as prof:
                    tts._generator.manual_seed(0)
                    run["wav_on"] = call()
            run["times_on"], run["path"] = tts.last_times, tts.last_path
            run["requests"] = pprof.requests()
            trace = tmp / f"{name}.json"
            prof.export_chrome_trace(str(trace))
            run["annotations"] = {
                e["name"] for e in json.loads(trace.read_text())["traceEvents"]
                if e.get("cat") == "user_annotation"}
            out[name] = run
    finally:
        torch.set_num_threads(n_threads)
        pprof.clear()
    return out


def _wav(out) -> np.ndarray:
    if isinstance(out, list):                      # infer_batch
        return np.concatenate([w for _, w in out])
    return out[1]


def test_without_a_profiler_nothing_records(runs):
    """``span`` and ``sync`` return the one shared no-op; ``stage`` still
    adds to its field; an engine call records no request."""
    assert not torch.autograd.profiler._is_profiler_enabled
    assert pprof.span("decode.step") is pprof.NO_SPAN
    assert pprof.span("cond", device=torch.device("cpu"), x=1) is pprof.NO_SPAN
    assert pprof.sync("done") is pprof.NO_SPAN
    with pprof.span("request") as sp:
        sp.set(rows=3)
        pprof.annotate(rows=3)
    times = StageTimes()
    with pprof.stage(times, "bigvgan") as sp:
        time.sleep(0.001)
    assert sp is pprof.NO_SPAN and times.bigvgan >= 0.001
    assert pprof.requests() == []
    for run in runs.values():
        assert run["recorded_off"] == 0


def test_recorder_nests_spans_and_attributes():
    """Ids, parent ids and the request id; attributes set while open; a
    span on a CPU device takes its host time as its device time, a span
    with no device has none; every span is a user annotation."""
    pprof.clear()
    try:
        with torch.profiler.profile(activities=CPU) as prof:
            with pprof.span("request", entry="x") as root:
                with pprof.span("cond", device=torch.device("cpu")) as a:
                    a.set(rows=2)
                    torch.ones(8).sum()
                with pprof.sync("done"):
                    pass
                pprof.annotate(frames=5)
            with pprof.span("other"):
                pass
        (req, other) = pprof.requests()
    finally:
        pprof.clear()
    assert [s.name for s in req] == ["request", "cond", "sync"]
    root, cond, sync = req
    assert root.parent is None and root.request == root.id
    assert cond.parent == sync.parent == root.id
    assert cond.request == sync.request == root.id
    assert root.attrs == {"entry": "x", "frames": 5}
    assert cond.attrs == {"rows": 2} and sync.attrs == {"at": "done"}
    assert cond.device_ms == pytest.approx(1e3 * (cond.t1 - cond.t0))
    assert root.device_ms is None and sync.device_ms is None
    assert root.t0 <= cond.t0 <= cond.t1 <= sync.t0 <= sync.t1 <= root.t1
    assert other[0].parent is None and other[0].request != root.id
    names = {e.name for e in prof.events()}
    assert {"request", "cond", "sync", "other"} <= names


@pytest.mark.parametrize("case", list(CASES))
def test_one_request_with_nested_spans(runs, case):
    """One ``request`` a call; the names above, parent links whose
    intervals nest; one ``decode.step`` a decode step after the token each
    decode's prefill picks; a ``sync`` at least every 8 steps."""
    entry, _, kw, path, decodes, must = CASES[case]
    run = runs[case]
    assert run["path"] == path
    (spans,) = run["requests"]
    root = spans[0]
    assert root.name == "request" and root.parent is None
    assert root.attrs["entry"] == entry
    assert root.attrs["cap"] == kw["max_mel_tokens"]
    times = run["times_on"]
    assert root.attrs["decode_steps"] == times.decode_steps
    assert root.attrs["frames"] * UPSAMPLE == _wav(run["wav_on"]).shape[0]
    names = {s.name for s in spans}
    assert names <= SPAN_NAMES
    assert {"request", "front", "cond", "speaker", "decode.prefill",
            "decode.step", "sync", "gpt_gen", "bigvgan"} | must <= names
    by_id = {s.id: s for s in spans}
    for s in spans[1:]:
        parent = by_id[s.parent]
        assert s.request == root.id
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    steps = sum(s.name == "decode.step" for s in spans)
    assert steps == times.decode_steps - decodes
    run_len = longest = 0
    for s in spans:
        if s.name == "decode.step":
            run_len += 1
            longest = max(longest, run_len)
        elif s.name == "sync":
            run_len = 0
    assert longest <= 8
    assert any(s.name == "sync" and s.attrs["at"] == "done" for s in spans)


@pytest.mark.parametrize("case", list(CASES))
def test_steps_and_requests_record_their_graphs(runs, case):
    """On the CPU no step replays a CUDA graph and no step launches kernel
    K3 or K4: every ``decode.step`` records ``graph`` 0, ``anc_attn`` 0
    and ``step_norm`` 0, and the request ``graph_captures`` 0."""
    (spans,) = runs[case]["requests"]
    assert spans[0].attrs["graph_captures"] == 0
    steps = [s for s in spans if s.name == "decode.step"]
    assert steps and all(s.attrs == {"graph": 0, "anc_attn": 0,
                                     "step_norm": 0} for s in steps)


@pytest.mark.parametrize("case", list(CASES))
def test_wav_is_bit_identical_with_tracing_on(runs, case):
    off, on = _wav(runs[case]["wav_off"]), _wav(runs[case]["wav_on"])
    assert off.dtype == on.dtype == np.int16 and off.size > 0
    np.testing.assert_array_equal(on, off)
    t_off, t_on = runs[case]["times_off"], runs[case]["times_on"]
    assert (t_on.decode, t_on.decode_steps, t_on.audio_seconds) == (
        t_off.decode, t_off.decode_steps, t_off.audio_seconds)


@pytest.mark.parametrize("case", list(CASES))
def test_stage_times_are_the_sums_of_their_stage_spans(runs, case):
    (spans,) = runs[case]["requests"]
    times = runs[case]["times_on"]
    for field in STAGES:
        want = 0.0
        for s in spans:
            if s.name == field:
                want += s.t1 - s.t0
        assert getattr(times, field) == want, field
    assert times.gpt_gen > 0 and times.bigvgan > 0


@pytest.mark.parametrize("case", list(CASES))
def test_chrome_trace_annotates_every_span(runs, case):
    (spans,) = runs[case]["requests"]
    assert {s.name for s in spans} <= runs[case]["annotations"]


def test_device_spans_take_host_time_on_the_cpu(runs):
    (spans,) = runs["infer_batch"]["requests"]
    for s in spans:
        if s.name in ("cond", "speaker", "decode.prefill", "latent",
                      "vocoder.plan", "vocoder.exact"):
            assert s.device_ms == pytest.approx(1e3 * (s.t1 - s.t0))
        else:
            assert s.device_ms is None


def test_request_deque_keeps_its_bound():
    pprof.clear()
    try:
        with torch.profiler.profile(activities=CPU):
            ids = []
            for _ in range(pprof.MAX_REQUESTS + 5):
                with pprof.span("request") as sp:
                    ids.append(sp.id)
        kept = pprof.requests()
    finally:
        pprof.clear()
    assert len(kept) == pprof.MAX_REQUESTS
    assert [r[0].id for r in kept] == ids[5:]


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
