"""F5-TTS in the port against the benchmark's plain reference
(``perfbench/reference/f5tts.py``) on the CPU, at a small size on seeded
random weights: DiT 64 wide, 2 layers, 4 heads of 16, text 32 wide with 2
ConvNeXt blocks, 3 Euler steps, the mel vocoder at 64 initial channels
(the ×256 chain's rates, kernels and dilations).

Tolerances: both sides compute in float32 on the CPU with the same
weights, so they differ only by the order of float32 operations (one row
against a padded batch, SDPA against an explicit softmax, fused against
split projections): 1e-5 relative on a DiT forward and on the text
encoder, 1e-4 relative on a whole ODE (three steps, each guided forward
amplifying the last one's rounding by the guidance's factor of three).
"""
import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu_torch.dubbing.engines import get_tts_engine
from index_tts_dubbing_tpu_torch.engine.f5 import F5Times, F5TTS, join_texts
from index_tts_dubbing_tpu_torch.models import dit
from index_tts_dubbing_tpu_torch.utils import audio as audio_util
from perfbench.families import f5tts as family
from perfbench.reference import f5tts as ref_mod

ROOT = Path(__file__).resolve().parent.parent
SEED = 2**31 + 23
FWD_TOL = 1e-5      # one forward, float32 on both sides
ODE_TOL = 1e-4      # three guided Euler steps
SAMPLER = {"nfe_step": 3, "cfg_strength": 2.0, "sway_sampling_coef": -1.0}


def _cfg():
    cfg = json.loads((ROOT / "perfbench" / "tests" / "data" /
                      "tiny.f5.json").read_text())
    cfg["vocoder"]["bigvgan"]["upsample_initial_channel"] = 64
    return cfg


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    cfg = _cfg()
    params = family.make_weights(cfg, SEED, "cpu", torch.float32)
    return (cfg, params, replace(family.f5_config(cfg), **SAMPLER),
            ref_mod.F5Reference(params, cfg))


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def _ids(n_ids: int, offset: int = 3):
    return [(offset + 7 * i) % 50 for i in range(n_ids)]


def _text(p, cfg, rows, lens):
    """The port's batched text encoder over ragged rows."""
    n = max(lens)
    host = torch.zeros(len(rows), n, dtype=torch.long)
    for i, (r, d) in enumerate(zip(rows, lens)):
        r = r[:d]
        host[i, : len(r)] = torch.tensor(r) + 1
    return dit.text_encoder(p["dit"]["text"], cfg.dit, host,
                            torch.tensor(lens), torch.float32)


def _mods(p, cfg, t):
    return dit.modulations(p["dit"], dit.time_embed(
        p["dit"]["time"], cfg.dit, torch.tensor([t]), torch.float32))


def test_text_encoder_matches_reference(setup):
    """Ragged rows through the port's masked batch equal each row encoded
    alone at its own length (GRN's norm runs over the row's time)."""
    cfg, p, c, ref = setup
    rows, lens = [_ids(12), _ids(30, 5)], [20, 41]
    got = _text(p, c, rows, lens)
    for i, (r, d) in enumerate(zip(rows, lens)):
        want = ref_mod.text_embed(p["dit"]["text"], ref.arch, r, d,
                                  torch.float32)[0]
        assert _rel(got[i, :d], want) < FWD_TOL
        assert not got[i, d:].any()


@pytest.mark.parametrize("guided", ["cond", "uncond"])
def test_dit_forward_matches_reference(setup, guided):
    """One forward of one row, conditioned (prompt mel and text) or
    unconditioned (both dropped)."""
    cfg, p, c, ref = setup
    n, t = 37, 0.41
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, n, 100, generator=g)
    cond = torch.randn(1, n, 100, generator=g)
    cond[:, 15:] = 0
    ids = _ids(25) if guided == "cond" else [-1] * n
    if guided == "uncond":
        cond = torch.zeros_like(cond)
    text = _text(p, c, [ids], [n])
    got = dit.forward(p["dit"], c.dit, x, cond, text, _mods(p, c, t), None)
    want = ref_mod.dit_forward(p["dit"], ref.arch, x, cond,
                               ref_mod.text_embed(p["dit"]["text"], ref.arch,
                                                  ids, n, torch.float32),
                               t, torch.float32)
    assert _rel(got, want) < FWD_TOL


def test_rotary_on_the_first_head_alone(setup):
    """``pe_attn_head`` 1 rotates head 0 only: the port matches the
    reference at 1, and the reference with every head rotated is another
    function (the check can tell them apart)."""
    cfg, p, c, ref = setup
    n, t = 29, 0.7
    g = torch.Generator().manual_seed(2)
    x, cond = torch.randn(1, n, 100, generator=g), torch.zeros(1, n, 100)
    ids = _ids(20)
    text = _text(p, c, [ids], [n])
    rtext = ref_mod.text_embed(p["dit"]["text"], ref.arch, ids, n,
                               torch.float32)
    got = dit.forward(p["dit"], c.dit, x, cond, text, _mods(p, c, t), None)
    one = ref_mod.dit_forward(p["dit"], ref.arch, x, cond, rtext, t,
                              torch.float32)
    every = ref_mod.dit_forward(p["dit"], dict(ref.arch, pe_attn_head=4), x,
                                cond, rtext, t, torch.float32)
    assert _rel(got, one) < FWD_TOL
    assert _rel(every, one) > 100 * FWD_TOL
    # the rotary is the identity at position 0 and keeps norms
    cos, sin = dit.rotary(n, 16, "cpu")
    q = torch.randn(1, 1, n, 16, generator=g)
    r = dit.apply_rotary(q, cos, sin)
    assert torch.allclose(r[..., 0, :], q[..., 0, :])
    assert torch.allclose(r.norm(dim=-1), q.norm(dim=-1), rtol=1e-6)


def test_padded_rows_are_masked(setup):
    """Three rows of different lengths in one forward: each row's frames
    equal that row's forward alone, whatever its padding holds."""
    cfg, p, c, ref = setup
    lens = [19, 40, 33]
    n = max(lens)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, n, 100, generator=g)
    cond = torch.randn(3, n, 100, generator=g)
    rows = [_ids(10), _ids(25, 4), _ids(16, 9)]
    valid = dit.valid_mask(torch.tensor(lens), n)
    x_junk = torch.where(valid[..., None], x, 1e3)
    text = _text(p, c, rows, lens)
    mods = _mods(p, c, 0.2)
    got = dit.forward(p["dit"], c.dit, x_junk, cond, text, mods, valid)
    for i, d in enumerate(lens):
        alone = dit.forward(p["dit"], c.dit, x[i: i + 1, :d],
                            cond[i: i + 1, :d], text[i: i + 1, :d], mods,
                            None)
        assert _rel(got[i, :d], alone[0]) < FWD_TOL


def test_ode_matches_reference(setup):
    """The whole guided ODE over two ragged rows from the noise the port
    drew: the reference samples each line alone from the same noise; the
    prompt's frames come back as they went in."""
    cfg, p, c, ref = setup
    eng = F5TTS(c, params=p, device="cpu", verbose_init=False)
    ref.cond = torch.randn(12, 100, generator=torch.Generator().manual_seed(4))
    durs = [30, 47]
    ids = [eng.text_ids(join_texts("a b.", "xy z.")),
           eng.text_ids(join_texts("a b.", "a longer line."))]
    out, noise = eng.sample(ref.cond, ids, durs, 11, F5Times())
    for i, d in enumerate(durs):
        want = ref.sample(ids[i], d, noise[i, :d], SAMPLER)
        assert _rel(out[i, :d], want) < ODE_TOL
        assert torch.equal(out[i, :12], ref.cond)
        assert not noise[i, d:].any()
    # row i's noise is what seed + i draws alone
    alone = torch.randn(durs[1], 100,
                        generator=torch.Generator().manual_seed(12))
    assert torch.equal(noise[1, : durs[1]], alone)


def test_time_grid_is_sway_sampled():
    t = ref_mod.time_grid(32, -1.0)
    from index_tts_dubbing_tpu_torch.engine.f5 import sway_grid
    got = sway_grid(32, -1.0, "cpu")
    assert got[0] == 0.0 and abs(float(got[-1]) - 1.0) < 1e-6
    assert torch.allclose(got, torch.tensor(t), atol=1e-7)
    # sway −1: t' = 1 − cos(πt/2), denser near 0
    assert float(got[1]) < 1.0 / 32 / 4


def _prompt(tmp_path, seconds=0.5):
    sr = 24000
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.3 * np.sin(2 * np.pi * 140 * t) * (1 + 0.3 * np.sin(9 * t))
    path = tmp_path / "prompt.wav"
    audio_util.write_wav(path, (wav * 32767).astype(np.int16), sr)
    return str(path)


def test_infer_batch_matches_per_line_infer(setup, tmp_path):
    """A batch of three lines of three durations equals each line served
    alone by ``infer`` with the seed the batch gives that row: the same
    mel within float32 reordering, the same int16 wav within 2 LSB."""
    cfg, p, c, ref = setup
    c = replace(c, nfe_step=2)
    eng = F5TTS(c, params=p, device="cpu", verbose_init=False,
                vocoder_window=32)
    prompt = _prompt(tmp_path)
    texts, secs = ["ab cd.", "a longer line here.", "mid one."], \
        [0.3, 0.9, 0.6]
    outs = eng.infer_batch(prompt, "the prompt.", texts, secs, seed=40)
    mel, tp = eng.last_mel, eng.last_prompt_frames
    for i, (text, sec) in enumerate(zip(texts, secs)):
        sr, wav = eng.infer(prompt, "the prompt.", text, sec, seed=40 + i)
        n = eng.last_frames[0]
        assert n == tp + eng.frames(sec) and sr == 24000
        assert _rel(mel[i, :n], eng.last_mel[0]) < FWD_TOL * 10
        assert outs[i][1].shape == wav.shape == ((n - tp) * 256, 1)
        diff = np.abs(outs[i][1].astype(np.int32) - wav.astype(np.int32))
        assert diff.max() <= 2


def test_f5_dubbing_engine_runs_on_the_port(setup, tmp_path):
    """``get_tts_engine("f5_tts")`` builds the port's engine on seeded
    weights given as ``params`` (no external package);
    ``synthesize_to_duration`` returns the requested length to the hop;
    the batch gives one wav a line."""
    cfg, p, c, ref = setup
    c = replace(c, nfe_step=1)
    eng = get_tts_engine("f5_tts", config=c, params=p, device="cpu",
                         verbose_init=False)
    assert isinstance(eng.tts, F5TTS)
    prompt = _prompt(tmp_path)
    kw = {"voice_reference": prompt, "ref_text": "hello there."}
    wav, sr = eng.synthesize_to_duration("a line.", 0.75, **kw)
    assert sr == 24000 and wav.dtype == np.float32
    assert wav.size == int(0.75 * 24000 / 256) * 256
    assert np.abs(wav).max() <= 1.0 and np.abs(wav).max() > 0
    wav2, _ = eng.synthesize("short.", **kw)
    assert wav2.size > 0 and wav2.size % 256 == 0
    outs = eng.synthesize_batch(["one.", "two two."], durations=[0.4, 0.6],
                                **kw)
    assert [w.size for w, _ in outs] == [int(s * 24000 / 256) * 256
                                         for s in (0.4, 0.6)]
    with pytest.raises(ValueError, match="voice_reference"):
        eng.synthesize("x.")


def test_f5_dubbing_engine_refuses_to_build_without_weights(setup):
    """Without ``params`` or ``engine`` the engine raises, naming the
    missing weights, rather than voice lines from random ones."""
    cfg, p, c, ref = setup
    with pytest.raises(ValueError, match="weights"):
        get_tts_engine("f5_tts", config=c, device="cpu")


class _RecordingF5:
    """Stands in for ``F5TTS``: records each ``infer_batch`` call and
    returns each line's exact frames of silence."""

    def __init__(self):
        self.calls = []

    def infer_batch(self, prompt, ref_text, texts, seconds_each, seed=None,
                    **sampler):
        self.calls.append((list(texts), list(seconds_each), seed, sampler))
        return [(24000, np.zeros((int(s * 24000 / 256) * 256, 1), np.int16))
                for s in seconds_each]


def test_adaptive_strategy_batches_lines_at_their_durations():
    """The adaptive strategy voices an F5 scene through ``synthesize_batch``
    with each entry's duration, in calls of ``lines_per_batch`` lines
    whose seeds continue line by line; an engine whose batch takes no
    durations keeps the per-entry ``synthesize_to_duration``."""
    from index_tts_dubbing_tpu_torch.dubbing.engines.f5_tts import (
        F5TTSEngine)
    from index_tts_dubbing_tpu_torch.dubbing.srt_parser import SRTEntry
    from index_tts_dubbing_tpu_torch.dubbing.strategies import get_strategy
    fake = _RecordingF5()
    eng = F5TTSEngine(engine=fake)
    eng.lines_per_batch = 2
    entries = [SRTEntry(i + 1, 2.0 * i, 2.0 * i + d, f"line {i}.")
               for i, d in enumerate((1.5, 0.5, 3.0))]
    segs = get_strategy("adaptive", eng).process_entries(
        entries, voice_reference="p.wav", ref_text="hi.", seed=7,
        nfe_step=4)
    assert [(t, s, seed) for t, s, seed, _ in fake.calls] == [
        (["line 0.", "line 1."], [1.5, 0.5], 7), (["line 2."], [3.0], 9)]
    assert all(kw == {"nfe_step": 4} for *_, kw in fake.calls)
    assert [len(g["audio_data"]) for g in segs] == [
        int(e.duration * 24000 / 256) * 256 for e in entries]

    class _PerLine(F5TTSEngine):
        batch_duration_control = False
    fake2 = _RecordingF5()
    fake2.infer = lambda prompt, ref_text, text, seconds=None, **kw: \
        fake2.infer_batch(prompt, ref_text, [text], [seconds], **kw)[0]
    get_strategy("adaptive", _PerLine(engine=fake2)).process_entries(
        entries, voice_reference="p.wav")
    assert [len(t) for t, *_ in fake2.calls] == [1, 1, 1]


def test_spans_record_under_a_profiler(setup, tmp_path):
    """Under a CPU ``torch.profiler`` one ``infer_batch`` is one request
    with its attributes, ``f5.text`` once, ``f5.ode`` holding one
    ``f5.nfe`` a step, and the vocoder's spans; untraced, nothing records
    and the wav is the same; ``last_times`` holds both stages' seconds."""
    from index_tts_dubbing_tpu_torch.utils import profiling
    cfg, p, c, ref = setup
    c = replace(c, nfe_step=2)
    eng = F5TTS(c, params=p, device="cpu", verbose_init=False,
                vocoder_window=32)
    prompt = _prompt(tmp_path)
    args = (prompt, "the prompt.", ["ab cd.", "a longer line here."],
            [0.3, 1.3])
    profiling.clear()
    plain = eng.infer_batch(*args, seed=5)
    assert profiling.requests() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = eng.infer_batch(*args, seed=5)
    (spans,) = profiling.requests()
    root = spans[0]
    tp = eng.last_prompt_frames
    assert root.name == "request" and root.attrs == {
        "entry": "infer_batch", "rows": 4, "frames": 4 * max(
            eng.last_frames), "real_frames": 2 * sum(eng.last_frames),
        "nfe": 2}
    names = [s.name for s in spans]
    assert names.count("f5.text") == 1 and names.count("f5.ode") == 1
    ode = next(s for s in spans if s.name == "f5.ode")
    steps = [s for s in spans if s.name == "f5.nfe"]
    assert [s.attrs["step"] for s in steps] == [0, 1]
    assert all(s.parent == ode.id and s.device_ms is not None
               for s in steps)
    assert {"ode", "bigvgan", "vocoder.plan", "vocoder.exact",
            "front"} <= set(names)
    assert eng.last_times.ode > 0 and eng.last_times.bigvgan > 0
    assert eng.last_frames[1] - tp > eng.vocoder.window \
        + 2 * eng.vocoder.halo                  # the plan ran
    for (_, a), (_, b) in zip(plain, traced):
        assert np.array_equal(a, b)
