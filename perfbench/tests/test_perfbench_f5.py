"""The F5-TTS family on the CPU at the tests' small size
(``data/tiny.f5.json``: DiT 64 wide, 2 layers, 3 Euler steps, the mel
vocoder at 64 channels; the mix ``data/tinyf5scene.json``: two lines of
two durations): the family is found by file, its mix is checked, each text
gets its own duration whatever order the seed gives, a sound run is
correct, and each fault of the timed path makes ``correct`` false."""
import json
import shutil

import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu_torch.engine import f5 as f5_mod
from index_tts_dubbing_tpu_torch.models import dit as dit_mod
from perfbench import check, families, harness, traffic
from perfbench.tests.conftest import DATA, ROOT, run_tiny

CELL = "f5scene.tiny"
# the IndexTTS scene cell's readers that also read the F5 cell
SHARED = ("k2_roofline.scene", "host_wait_share.scene",
          "vocoder_exact_share.scene")


@pytest.fixture
def f5_root(tiny_root):
    """The tests' checkout with the F5 configuration, mix, limits and cell
    added as new files and entries, its metrics pointed at the cell."""
    shutil.copy(DATA / "tiny.f5.json", tiny_root / "tiny.f5.json")
    shutil.copy(DATA / "tinyf5scene.json",
                tiny_root / "perfbench" / "traffic" / "tinyf5scene.json")
    shutil.copy(DATA / "tiny.f5.limits.json",
                tiny_root / "perfbench" / "limits" / f"{CELL}.json")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny.f5", "source": "tests",
                             "file": "tiny.f5.json", "reduced": ["arch"],
                             "why": "small"})
    bench["workloads"].append({"name": CELL, "config": "tiny.f5",
                               "traffic": "tinyf5scene", "chips": 1,
                               "why": "small"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"].endswith(".f5scene") \
                or m["name"] == "scene_audio_s_per_s":
            m["workloads"] = [CELL]
        elif m["name"] in SHARED:
            m["workloads"].append(CELL)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_root


def _mix():
    return json.loads((ROOT / "perfbench" / "traffic" /
                       "f5scene.json").read_text())


def test_f5tts_loads_by_file(f5_root):
    fam = families.load("f5tts", ROOT)
    for name in ("check_mix", "call_kwargs", "Program", "compare",
                 "control", "trace_hook", "CALL_COLUMNS", "call_columns",
                 "compared_line"):
        assert hasattr(fam, name), name
    cell = harness.load_cell(f5_root, CELL)
    assert cell.family.__file__.endswith("f5tts.py")
    assert [m["name"] for m in cell.per_layer] == list(SHARED) + [
        "nfe_ms.f5scene", "mfu.f5scene", "idle_share.f5scene",
        "vocoder_s_per_audio_s.f5scene"]
    real = harness.load_cell(ROOT, "scene.f5-bf16")
    assert sorted(m["name"] for m in real.per_layer) == sorted(
        [m["name"] for m in cell.per_layer])
    assert real.family.__name__ == "perfbench_family_f5tts"
    assert [m["name"] for m in real.end_to_end] == ["scene_audio_s_per_s",
                                                    "setup_s"]


@pytest.mark.parametrize("broken", ["no-seconds", "short-seconds",
                                    "two-durations", "no-prompt-chars",
                                    "entry", "no-decode", "decode-keys"])
def test_check_mix_refuses(tmp_path, broken):
    mix = _mix()
    s = mix["slots"][0]
    if broken == "no-seconds":
        del s["seconds"]
    elif broken == "short-seconds":
        s["seconds"] = s["seconds"][:-1]
    elif broken == "two-durations":
        s["seconds"][1] = 9.0
    elif broken == "no-prompt-chars":
        del mix["prompt_chars"]
    elif broken == "no-decode":
        del mix["decode"]
    elif broken == "decode-keys":
        mix["decode"]["num_beams"] = 3
    else:
        mix["entry"] = "infer_fast"
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(mix))
    with pytest.raises(ValueError):
        traffic.load(path, families.load("f5tts", ROOT))


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**33 + 9])
def test_each_text_gets_its_duration(seed):
    """Whatever order the seed puts the texts in, each text's duration is
    its slot's for its token count, and the call holds every duration of
    the slot once for each of its texts."""
    fam = families.load("f5tts", ROOT)
    mix = _mix()
    slot = mix["slots"][0]
    want = dict(zip(slot["chars"], slot["seconds"]))
    orders = set()
    for call, _ in zip(traffic.calls(mix, seed, fam), range(3)):
        by = call.kwargs["seconds_by_tokens"]
        secs = [by[fam.tokens(t)] for t in call.texts]
        assert [want[fam.tokens(t)] for t in call.texts] == secs
        assert sorted(secs) == sorted(slot["seconds"])
        orders.add(tuple(fam.tokens(t) for t in call.texts))
    assert len(orders) > 1                  # the seed does reorder them


def test_sound_run_is_correct(f5_root):
    r, lines = run_tiny(f5_root, CELL, seconds=0.5)
    assert r["correct"] is True, lines[-3:]
    assert set(r["checks"]) == {"mel_err", "wav_err"}
    assert set(r["metrics"]) == {"setup_s", "scene_audio_s_per_s"}
    assert lines[0] == ("call slot cap wall_s audio_s rows frames ode_s "
                        "bigvgan_s")
    assert lines[-3].startswith("compared calls 1 generated frames ")


def test_traced_run_reads_the_new_metrics(f5_root):
    """On the CPU the device readers (idle share, K2's roofline) find
    nothing to read; the other four new and shared readers read above 0
    (the host waits: the ODE's synchronize is a CUDA one, but the h2d copy
    and the wav's transfer are waits)."""
    r, _ = run_tiny(f5_root, CELL, trace=True, seconds=0.5)
    assert set(r["metrics"]) == {"nfe_ms.f5scene", "mfu.f5scene",
                                 "vocoder_s_per_audio_s.f5scene",
                                 "vocoder_exact_share.scene",
                                 "host_wait_share.scene"}
    assert all(v["value"] > 0 for v in r["metrics"].values())


def _step_skipped(monkeypatch):
    """Every call's second Euler step adds nothing."""
    orig, count = dit_mod.forward, [0]

    def forward(*a, **k):
        count[0] += 1
        v = orig(*a, **k)
        return torch.zeros_like(v) if count[0] % 3 == 2 else v
    monkeypatch.setattr(dit_mod, "forward", forward)


def _guidance_dropped(monkeypatch):
    """The unconditioned rows give the conditioned rows' velocity, so
    v = v_c."""
    orig = dit_mod.forward

    def forward(*a, **k):
        v = orig(*a, **k)
        h = v.shape[0] // 2
        return torch.cat([v[:h], v[:h]])
    monkeypatch.setattr(dit_mod, "forward", forward)


def _mel_zeroed(monkeypatch):
    """A stretch of every row's generated mel zeroed before the vocoder."""
    orig = f5_mod.F5TTS.sample

    def sample(self, cond, *a, **k):
        out, noise = orig(self, cond, *a, **k)
        tp = cond.shape[0]
        out = out.clone()
        out[:, tp + 3: tp + 12] = 0
        return out, noise
    monkeypatch.setattr(f5_mod.F5TTS, "sample", sample)


def _half_batch(monkeypatch):
    """The second half of a call's lines comes back empty."""
    orig = f5_mod.F5TTS.infer_batch

    def infer_batch(self, *a, **k):
        outs = orig(self, *a, **k)
        h = len(outs) // 2
        return outs[:h] + [(sr, w[:0]) for sr, w in outs[h:]]
    monkeypatch.setattr(f5_mod.F5TTS, "infer_batch", infer_batch)


def _noise_shared(monkeypatch):
    """Every row of a call starts from the first row's noise."""
    orig = f5_mod.F5TTS.draw_noise

    def draw_noise(self, durs, n, seed):
        x = orig(self, [n] * len(durs), n, seed)
        return x[:1].repeat(len(durs), 1, 1)
    monkeypatch.setattr(f5_mod.F5TTS, "draw_noise", draw_noise)


def _noise_seed_shifted(monkeypatch):
    """Row i draws row i + 1's noise (seed + i + 1)."""
    orig = f5_mod.F5TTS.draw_noise
    monkeypatch.setattr(f5_mod.F5TTS, "draw_noise",
                        lambda self, durs, n, seed: orig(self, durs, n,
                                                         seed + 1))


@pytest.mark.parametrize("fault", [_step_skipped, _guidance_dropped,
                                   _mel_zeroed, _half_batch, _noise_shared,
                                   _noise_seed_shifted],
                         ids=["step-skipped", "guidance-dropped",
                              "mel-zeroed", "half-batch", "noise-shared",
                              "noise-seed-shifted"])
def test_fault_makes_correct_false(f5_root, monkeypatch, fault):
    fault(monkeypatch)
    r, lines = run_tiny(f5_root, CELL, seconds=0.5)
    assert r["correct"] is False, lines[-3:]
    assert any(not np.isfinite(c["value"]) or c["value"] > c["limit"]
               for c in r["checks"].values()), lines


def test_control_fails_at_small_size(f5_root, tmp_path):
    """The control (the reference in bfloat16) in the program's place reads
    above a limit, where the program reads inside them."""
    torch.set_num_threads(2)
    cell = harness.load_cell(f5_root, CELL)
    fam, cfg, mix, seed = cell.family, cell.config, cell.mix, 2**31 + 11
    prog = harness.Program(cell, seed, "cpu", tmp_path)
    call = next(traffic.calls(mix, seed, fam))
    records = [prog.serve(call)]
    harness.host_codes(records)
    sound = check.judge(fam.compare(records, [0], cfg, mix, seed,
                                    prog.prompt, "cpu"), cell.limits)
    ctrl = check.judge(fam.compare(records, [0], cfg, mix, seed, prog.prompt,
                                   "cpu", as_control=True), cell.limits)
    assert all(c["ok"] for c in sound.values()), sound
    assert not all(c["ok"] for c in ctrl.values()), ctrl
