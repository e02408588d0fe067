"""The port's dubbing layer (index_tts_dubbing_tpu_torch.dubbing): every test
of tests/test_dubbing.py against the port's modules (parsers, strategies
with a fake engine, merge semantics, time stretch, the CLI end to end, the
scripted duration-candidate search), then the port against the JAX package:

- the parsers, the time stretch, every strategy and both merges give the
  same result bit for bit on the same engine audio (the modules are copies);
- the adapter's batched duration candidates are distinct samples on the
  port's engine;
- the basic and stretch pipelines end to end on both engines, at the small
  config of tests/test_torch_engine.py (float32, beam search, the decode cap
  passed through the strategy's kwargs).
"""
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.dubbing import strategies as jstrategies
from index_tts_dubbing_tpu.dubbing.audio_processor import \
    AudioProcessor as JaxAudioProcessor
from index_tts_dubbing_tpu.dubbing.engines.base import \
    BaseTTSEngine as JaxBaseTTSEngine
from index_tts_dubbing_tpu.dubbing.engines.index_tts import \
    IndexTTSEngine as JaxIndexTTSEngine
from index_tts_dubbing_tpu.dubbing.srt_parser import SRTParser as JaxSRTParser
from index_tts_dubbing_tpu.dubbing.time_stretch import \
    time_stretch_hq as jax_time_stretch_hq
from index_tts_dubbing_tpu.dubbing.txt_parser import TXTParser as JaxTXTParser
from index_tts_dubbing_tpu_torch.dubbing.audio_processor import AudioProcessor
from index_tts_dubbing_tpu_torch.dubbing.engines.base import BaseTTSEngine
from index_tts_dubbing_tpu_torch.dubbing.engines.index_tts import \
    IndexTTSEngine
from index_tts_dubbing_tpu_torch.dubbing.srt_parser import SRTEntry, SRTParser
from index_tts_dubbing_tpu_torch.dubbing.strategies import (
    get_strategy, list_available_strategies)
from index_tts_dubbing_tpu_torch.dubbing.time_stretch import time_stretch_hq
from index_tts_dubbing_tpu_torch.dubbing.txt_parser import TXTParser
from tests.test_torch_engine import I16_TOL, make_engines

SRT_SAMPLE = """1
00:00:00,000 --> 00:00:02,000
Hello world.

2
00:00:02,500 --> 00:00:04,000
第二段字幕
"""
# three entries, one of them Chinese, for the engines at the small config:
# each entry's 40 decode steps give 40 * 1024 samples (1.71 s at 24 kHz), so
# the stretch rates are 1.42 (inside the clamp), 1.90 (clamped to 1.5) and
# 1.22
SRT_THREE = """1
00:00:00,000 --> 00:00:01,200
Hello there friend.

2
00:00:01,500 --> 00:00:02,400
第二段字幕来了

3
00:00:02,600 --> 00:00:04,000
The quick brown fox jumps.
"""
STRATEGIES = ["basic", "stretch", "hq_stretch", "adaptive"]
ENGINE_KW = dict(do_sample=False, max_mel_tokens=40)


class FakeEngine(BaseTTSEngine):
    """Deterministic sine-tone engine: 0.1 s per character."""

    sr = 22050

    def synthesize(self, text, **kwargs):
        if not kwargs.get("voice_reference"):
            raise ValueError("voice_reference is required")
        n = int(len(text) * 0.1 * self.sr)
        t = np.arange(n) / self.sr
        return (0.2 * np.sin(2 * np.pi * 440 * t)).astype(np.float32), self.sr

    def synthesize_to_duration(self, text, target_duration, **kwargs):
        n = int(target_duration * self.sr)
        t = np.arange(n) / self.sr
        return (0.2 * np.sin(2 * np.pi * 440 * t)).astype(np.float32), self.sr


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process; one torch
    thread runs these small decodes many times faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ tests/test_dubbing.py


def test_srt_parse():
    entries = SRTParser().parse_content(SRT_SAMPLE)
    assert len(entries) == 2
    assert entries[0].start_time == 0.0 and entries[0].end_time == 2.0
    assert entries[1].text == "第二段字幕"
    assert abs(entries[1].duration - 1.5) < 1e-9
    assert SRTParser().validate_entries(entries)
    assert SRTParser.seconds_to_time(3661.5) == "01:01:01,500"


def test_srt_parse_bad_timestamp():
    with pytest.raises(ValueError):
        SRTParser().parse_content("1\n00:00 --> 00:01\nxx\n")


def test_txt_parse():
    entries = TXTParser().parse_content("One sentence. Another one! 中文句子。最后")
    assert [e.text for e in entries] == \
        ["One sentence.", "Another one!", "中文句子。", "最后"]
    assert all(e.duration == 0 for e in entries)


def test_strategies_registry():
    names = list_available_strategies()
    assert {"basic", "stretch", "hq_stretch", "adaptive"} <= set(names)
    assert names == jstrategies.list_available_strategies()


@pytest.mark.parametrize("name", STRATEGIES)
def test_strategy_process(name):
    entries = SRTParser().parse_content(SRT_SAMPLE)
    strat = get_strategy(name, FakeEngine())
    segments = strat.process_entries(entries, voice_reference="x.wav")
    assert len(segments) == 2
    for seg, entry in zip(segments, entries):
        assert seg["index"] == entry.index
        assert isinstance(seg["audio_data"], np.ndarray)
        assert seg["audio_data"].size > 0


def test_stretch_matches_duration():
    entries = [SRTEntry(1, 0.0, 1.0, "x" * 20)]  # natural 2.0s → rate 2→clamp 1.5
    strat = get_strategy("stretch", FakeEngine())
    segments = strat.process_entries(entries, voice_reference="x.wav")
    dur = segments[0]["audio_data"].size / FakeEngine.sr
    # clamped to 1.5x speedup: 2.0/1.5 ≈ 1.33s (overlap allowed, no pad)
    assert 1.1 < dur < 1.6


def test_strategy_failure_fallback():
    class Failing(FakeEngine):
        def synthesize(self, text, **kw):
            raise RuntimeError("boom")

    entries = SRTParser().parse_content(SRT_SAMPLE)
    segments = get_strategy("basic", Failing()).process_entries(
        entries, voice_reference="x.wav")
    assert len(segments) == 2
    assert np.all(segments[0]["audio_data"] == 0)


def test_merge_natural_concat():
    proc = AudioProcessor(sample_rate=100)
    segs = [
        {"audio_data": np.ones(50, np.float32), "start_time": 0.0,
         "end_time": 0.5, "index": 2},
        {"audio_data": np.full(30, 2.0, np.float32), "start_time": 1.0,
         "end_time": 1.3, "index": 1},
    ]
    out = proc.merge_audio_segments(segs, strategy_name="basic")
    assert out.size == 80
    assert np.all(out[:30] == 2.0)  # index order, not time order


def test_merge_time_synchronized():
    proc = AudioProcessor(sample_rate=100)
    segs = [
        {"audio_data": np.ones(50, np.float32), "start_time": 0.0,
         "end_time": 0.5, "index": 1},
        {"audio_data": np.ones(30, np.float32), "start_time": 1.0,
         "end_time": 1.3, "index": 2},
    ]
    out = proc.merge_audio_segments(segs, strategy_name="stretch")
    assert np.all(out[:50] == 1.0)
    assert np.all(out[50:100] == 0.0)
    assert np.all(out[100:130] == 1.0)


def test_merge_overlap_pushback():
    proc = AudioProcessor(sample_rate=100)
    segs = [
        {"audio_data": np.ones(120, np.float32), "start_time": 0.0,
         "end_time": 1.0, "index": 1},
        {"audio_data": np.ones(30, np.float32), "start_time": 1.0,
         "end_time": 1.3, "index": 2},
    ]
    out = proc.merge_audio_segments(segs, strategy_name="stretch")
    # second segment pushed back to sample 120 (no overlap-add doubling)
    assert np.max(out) <= 1.0
    assert np.all(out[120:150] == 1.0)


def test_time_stretch_hq_length():
    sr = 22050
    t = np.arange(sr) / sr
    y = np.sin(2 * np.pi * 220 * t).astype(np.float32)
    for rate in (0.75, 1.5):
        out = time_stretch_hq(y, rate, sr)
        expected = len(y) / rate
        assert abs(len(out) - expected) / expected < 0.05
        assert np.max(np.abs(out)) > 0.1  # not silence


def test_cli_end_to_end(tmp_path, monkeypatch):
    from index_tts_dubbing_tpu_torch.dubbing import cli as cli_mod
    from index_tts_dubbing_tpu_torch.utils.audio import read_wav, write_wav

    srt = tmp_path / "in.srt"
    srt.write_text(SRT_SAMPLE, encoding="utf-8")
    voice = tmp_path / "voice.wav"
    write_wav(voice, np.zeros(1000, np.float32), 22050)
    out = tmp_path / "out.wav"

    monkeypatch.setattr(
        "index_tts_dubbing_tpu_torch.dubbing.engines.get_tts_engine",
        lambda name, **kw: FakeEngine())
    monkeypatch.setattr(cli_mod, "get_tts_engine",
                        lambda name, **kw: FakeEngine())
    rc = cli_mod.main(["--srt", str(srt), "--voice", str(voice),
                       "--output", str(out), "--strategy", "basic",
                       "--sample-rate", "22050"])
    assert rc == 0
    wav, sr = read_wav(out)
    assert sr == 22050 and wav.shape[1] > 0


def test_duration_candidate_search():
    """IndexTTSEngine.synthesize_to_duration: batched candidate search picks
    the nearest-duration COMPLETE utterance (no max_mel_tokens truncation),
    ≤0.1 s error when a candidate lands inside tolerance."""
    sr = 24000
    calls = {"batch": 0, "kwargs": []}

    class ScriptedTTS:
        """Stands in for IndexTTS: natural infer = 3.0 s; one batched
        candidate call returns 2.2 / 1.95 / 1.6 / 2.8 s utterances."""

        def infer(self, voice, text, out, **kw):
            calls["kwargs"].append(kw)
            return sr, np.zeros((int(3.0 * sr), 1), np.int16)

        def infer_batch(self, voice, texts, **kw):
            calls["batch"] += 1
            calls["kwargs"].append(kw)
            durs = [2.2, 1.95, 1.6, 2.8]
            return [(sr, np.zeros((int(d * sr), 1), np.int16))
                    for d, _ in zip(durs, texts)]

    eng = IndexTTSEngine(engine=ScriptedTTS())
    audio, got_sr = eng.synthesize_to_duration(
        "hello there", 2.0, voice_reference="v.wav")
    assert got_sr == sr
    assert abs(len(audio) / sr - 2.0) <= 0.1          # picked the 1.95 s one
    assert calls["batch"] == 1                        # ONE batched retry
    # no truncating mel budget was ever injected
    assert all("max_mel_tokens" not in kw for kw in calls["kwargs"])


def test_duration_within_tolerance_short_circuits():
    sr = 24000

    class OneShotTTS:
        def infer(self, voice, text, out, **kw):
            return sr, np.zeros((int(2.05 * sr), 1), np.int16)

        def infer_batch(self, *a, **kw):
            raise AssertionError("no batch needed inside tolerance")

    eng = IndexTTSEngine(engine=OneShotTTS())
    audio, _ = eng.synthesize_to_duration("hi", 2.0,
                                          voice_reference="v.wav")
    assert abs(len(audio) / sr - 2.05) < 1e-3


def test_txt_parse_abbreviations():
    """pysbd-grade segmentation: abbreviations, decimals, initials and
    ellipses must not split (reference txt_parser.py:7-53 uses pysbd)."""
    from index_tts_dubbing_tpu_torch.dubbing.txt_parser import split_sentences

    assert split_sentences("Dr. Smith went home. It was late.") == \
        ["Dr. Smith went home.", "It was late."]
    assert split_sentences("Pi is 3.5. Next sentence.") == \
        ["Pi is 3.5.", "Next sentence."]
    assert split_sentences("J. K. Rowling wrote it. Yes.") == \
        ["J. K. Rowling wrote it.", "Yes."]
    assert split_sentences("Wait... really? Yes!") == \
        ["Wait... really?", "Yes!"]
    assert split_sentences("e.g. apples are fine. Done.") == \
        ["e.g. apples are fine.", "Done."]
    assert split_sentences('"Quoted." Next.') == ['"Quoted."', "Next."]


# ------------------------------------------------ against the JAX package


def test_parsers_and_time_stretch_match_jax():
    """The copies parse and stretch exactly as the JAX package's modules."""
    text = "One sentence. Dr. Smith went home. 中文句子。最后 Wait... really?"
    assert ([tuple(e) for e in TXTParser().parse_content(text)]
            == [tuple(e) for e in JaxTXTParser().parse_content(text)])
    assert ([tuple(e) for e in SRTParser().parse_content(SRT_THREE)]
            == [tuple(e) for e in JaxSRTParser().parse_content(SRT_THREE)])
    y = np.random.default_rng(0).standard_normal(24000).astype(np.float32)
    for rate in (0.7, 0.93, 1.22, 1.5):
        np.testing.assert_array_equal(time_stretch_hq(y * 0.1, rate, 24000),
                                      jax_time_stretch_hq(y * 0.1, rate, 24000))


class NoiseEngine(BaseTTSEngine):
    """Seeded noise, 0.07 s per character, with no batched path."""

    sr = 24000

    def synthesize(self, text, **kwargs):
        n = int(len(text) * 0.07 * self.sr)
        rng = np.random.default_rng(len(text))
        return (0.1 * rng.standard_normal(n)).astype(np.float32), self.sr

    def synthesize_to_duration(self, text, target_duration, **kwargs):
        return self.synthesize(text * 2, **kwargs)


class JaxNoiseEngine(JaxBaseTTSEngine):
    synthesize = NoiseEngine.synthesize
    synthesize_to_duration = NoiseEngine.synthesize_to_duration
    sr = NoiseEngine.sr


@pytest.mark.parametrize("name", STRATEGIES)
def test_strategy_and_merge_match_jax_on_the_same_audio(name):
    """Every strategy and the merge it selects, on the same engine audio:
    the port's segments and merged wav equal the JAX package's bit for bit
    (rates inside the clamp, clamped, and under 1)."""
    kw = dict(voice_reference="v.wav")
    segs = get_strategy(name, NoiseEngine()).process_entries(
        SRTParser().parse_content(SRT_THREE), **kw)
    jsegs = jstrategies.get_strategy(name, JaxNoiseEngine()).process_entries(
        JaxSRTParser().parse_content(SRT_THREE), **kw)
    assert len(segs) == len(jsegs) == 3
    for seg, jseg in zip(segs, jsegs):
        assert seg.keys() == jseg.keys()
        for key in seg:
            np.testing.assert_array_equal(seg[key], jseg[key])
    np.testing.assert_array_equal(
        AudioProcessor(24000).merge_audio_segments(segs, name),
        JaxAudioProcessor(24000).merge_audio_segments(jsegs, name))


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return make_engines(tmp_path_factory.mktemp("dubbing"))


def record_batches(adapter):
    """Keep every (audio, sr) that ``adapter.synthesize_batch`` returns."""
    got = []
    inner = adapter.synthesize_batch

    def wrapped(texts, **kwargs):
        out = inner(texts, **kwargs)
        got.extend(out)
        return out

    adapter.synthesize_batch = wrapped
    return got


# basic concatenates the engines' samples unchanged: the int16 bound carries
# over, I16_TOL LSB of the 32768 the adapter divides by
BASIC_TOL = I16_TOL / 32768.0
# time_stretch_hq is not linear in its input: its phase vocoder (3/4 of the
# blend through pitch_shift, 1/4 directly) rebuilds each bin's phase from
# angles and carries it to later frames, so a quiet bin's phase can move
# further than the input did and no sample bound follows from BASIC_TOL.
# The stretched wav is held instead by its error energy: at least 40 dB
# under the reference's signal energy, where a wrong rate, order or
# placement gives about 0 dB.
STRETCH_MIN_SNR_DB = 40.0


@pytest.mark.parametrize("name", ["basic", "stretch"])
def test_strategy_on_both_engines_matches_jax(engines, name):
    """The adapter on each engine, one batched infer_batch per package, beam
    search at a 40-step cap: the engines' audio per entry within BASIC_TOL,
    then the merged wav of basic within BASIC_TOL and of stretch (the same
    length, so the same rates) within STRETCH_MIN_SNR_DB."""
    jeng, peng, prompt = engines
    kw = dict(voice_reference=prompt, **ENGINE_KW)
    adapter, jadapter = IndexTTSEngine(engine=peng), JaxIndexTTSEngine(engine=jeng)
    got, jgot = record_batches(adapter), record_batches(jadapter)
    segs = get_strategy(name, adapter).process_entries(
        SRTParser().parse_content(SRT_THREE), **kw)
    jsegs = jstrategies.get_strategy(name, jadapter).process_entries(
        JaxSRTParser().parse_content(SRT_THREE), **kw)
    assert peng.last_path == jeng.last_path == "fused"
    assert len(got) == len(jgot) == 3
    for (audio, sr), (jaudio, jsr) in zip(got, jgot):
        assert sr == jsr == 24000 and audio.shape == jaudio.shape
        assert np.abs(audio - jaudio).max() <= BASIC_TOL
    merged = AudioProcessor(24000).merge_audio_segments(segs, name)
    jmerged = JaxAudioProcessor(24000).merge_audio_segments(jsegs, name)
    assert merged.shape == jmerged.shape and np.isfinite(merged).all()
    err = merged - jmerged
    if name == "basic":
        assert np.abs(err).max() <= BASIC_TOL
    else:
        snr = 10 * np.log10(np.sum(jmerged.astype(np.float64) ** 2)
                            / max(np.sum(err.astype(np.float64) ** 2), 1e-30))
        assert snr >= STRETCH_MIN_SNR_DB, snr


def test_batched_duration_candidates_are_distinct(engines):
    """synthesize_to_duration on the port's engine with its default beam
    sampling: one infer plus one infer_batch of n_candidates identical
    texts, whose rows decode distinct codes (each row draws its own noise
    from the engine's generator)."""
    _, peng, prompt = engines
    calls = []

    class Counting:
        def __init__(self, eng):
            self.eng = eng

        def infer(self, *args, **kwargs):
            calls.append("infer")
            return self.eng.infer(*args, **kwargs)

        def infer_batch(self, *args, **kwargs):
            calls.append("infer_batch")
            return self.eng.infer_batch(*args, **kwargs)

    adapter = IndexTTSEngine(engine=Counting(peng))
    audio, sr = adapter.synthesize_to_duration(
        "Hello there friend.", 0.5, voice_reference=prompt, max_mel_tokens=24)
    assert calls == ["infer", "infer_batch"]
    assert sr == 24000 and audio.size and np.isfinite(audio).all()
    assert peng.last_path == "fused"
    assert peng.last_times.decode.startswith("beam sampling")
    codes = peng.last_fused_res.codes[:4].numpy()
    assert codes.shape == (4, 24)
    for i in range(4):
        for j in range(i):
            assert not np.array_equal(codes[i], codes[j]), (i, j)
