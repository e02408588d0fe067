"""The IndexTTS-2 family on the CPU at the tests' small size
(``data/tiny.v2.json``: GPT 64 wide, 2 layers; the S2M DiT 32 wide, 5
blocks, 3 Euler steps; the mel vocoder at 64 channels; the mix
``data/tinyv2scene.json``: two lines at cap 12, 2 beams): the family is
found by file, its mix is checked, a sound run is correct and reads the
new and shared metrics, the roofline's count holds a hand count, and each
fault of the timed path makes ``correct`` false."""
import json
import shutil

import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu_torch.engine import decode as decode_mod
from index_tts_dubbing_tpu_torch.engine import indextts2 as v2_mod
from index_tts_dubbing_tpu_torch.models import gpt as gpt_model
from index_tts_dubbing_tpu_torch.models import s2m as s2m_mod
from perfbench import check, families, harness, traffic
from perfbench.roofline import indextts2 as v2_roofline
from perfbench.tests.conftest import DATA, ROOT, run_tiny

CELL = "v2scene.tiny"
# the IndexTTS scene cell's readers that also read the IndexTTS-2 cell
SHARED = ("decode_ms_per_step.scene", "vocoder_s_per_audio_s.scene",
          "k2_roofline.scene", "idle_share.scene", "step_issue_ms.scene",
          "host_wait_share.scene", "prefill_ms.scene",
          "vocoder_exact_share.scene", "graph_step_share.scene",
          "anc_attn_share.scene")
NEW = ("s2m_nfe_ms.v2scene", "mfu.v2scene")


@pytest.fixture
def v2_root(tiny_root):
    """The tests' checkout with the IndexTTS-2 configuration, mix, limits
    and cell added as new files and entries, its metrics pointed at the
    cell."""
    shutil.copy(DATA / "tiny.v2.json", tiny_root / "tiny.v2.json")
    shutil.copy(DATA / "tinyv2scene.json",
                tiny_root / "perfbench" / "traffic" / "tinyv2scene.json")
    shutil.copy(DATA / "tiny.v2.limits.json",
                tiny_root / "perfbench" / "limits" / f"{CELL}.json")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny.v2", "source": "tests",
                             "file": "tiny.v2.json", "reduced": ["gpt"],
                             "why": "small"})
    bench["workloads"].append({"name": CELL, "config": "tiny.v2",
                               "traffic": "tinyv2scene", "chips": 1,
                               "why": "small"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in NEW or m["name"] == "scene_audio_s_per_s":
            m["workloads"] = [CELL]
        elif m["name"] in SHARED:
            m["workloads"].append(CELL)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_root


def _mix():
    return json.loads((ROOT / "perfbench" / "traffic" /
                       "v2scene.json").read_text())


def test_indextts2_loads_by_file(v2_root):
    fam = families.load("indextts2", ROOT)
    for name in ("check_mix", "call_kwargs", "Program", "compare",
                 "control", "trace_hook", "CALL_COLUMNS", "call_columns",
                 "compared_line"):
        assert hasattr(fam, name), name
    cell = harness.load_cell(v2_root, CELL)
    assert cell.family.__file__.endswith("indextts2.py")
    real = harness.load_cell(ROOT, "scene.v2-bf16")
    assert sorted(m["name"] for m in real.per_layer) == sorted(SHARED + NEW)
    assert sorted(m["name"] for m in cell.per_layer) == sorted(SHARED + NEW)
    assert real.family.__name__ == "perfbench_family_indextts2"
    assert [m["name"] for m in real.end_to_end] == ["scene_audio_s_per_s",
                                                    "setup_s"]
    assert real.config["gpt"]["layers"] == 24      # what anc_attn_share reads
    assert real.mix["slots"][0]["cap"] == 350


@pytest.mark.parametrize("broken", ["no-decode", "decode-keys", "entry",
                                    "greedy", "penalty", "infer-two"])
def test_check_mix_refuses(tmp_path, broken):
    mix = _mix()
    if broken == "no-decode":
        del mix["decode"]
    elif broken == "decode-keys":
        mix["decode"]["nfe_step"] = 25
    elif broken == "entry":
        mix["entry"] = "infer_fast"
    elif broken == "greedy":
        mix["decode"]["num_beams"] = 1
    elif broken == "penalty":
        mix["decode"]["repetition_penalty"] = 5.0
    else:
        mix["entry"] = "infer"
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(mix))
    with pytest.raises(ValueError):
        traffic.load(path, families.load("indextts2", ROOT))


def test_call_kwargs_carry_the_cap_and_the_defaults():
    fam = families.load("indextts2", ROOT)
    mix = _mix()
    kw = fam.call_kwargs(mix, 0)
    assert kw["max_mel_tokens"] == 350 and kw["num_beams"] == 3
    assert kw["temperature"] == 0.8 and kw["top_k"] == 30
    call = next(traffic.calls(mix, 2**33 + 9, fam))
    assert sorted(fam_tokens(t) for t in call.texts) == sorted(
        mix["slots"][0]["chars"])


def fam_tokens(text):
    return sum(not c.isspace() for c in text)


def test_sound_run_is_correct(v2_root):
    r, lines = run_tiny(v2_root, CELL, seconds=0.5)
    assert r["correct"] is True, lines[-4:]
    assert set(r["checks"]) == {"code_gap", "mel_err", "wav_err"}
    assert set(r["metrics"]) == {"setup_s", "scene_audio_s_per_s"}
    assert lines[0] == ("call slot cap wall_s audio_s rows steps gpt_gen_s "
                        "s2m_s bigvgan_s")
    assert lines[-4].startswith("compared calls 1 served codes ")


def test_traced_run_reads_the_new_metrics(v2_root):
    """On the CPU the device readers (idle share, K2's roofline, graphs,
    K3) find nothing to read; the new readers and the shared span readers
    read above 0."""
    r, _ = run_tiny(v2_root, CELL, trace=True, seconds=0.5)
    want = {"s2m_nfe_ms.v2scene", "mfu.v2scene", "decode_ms_per_step.scene",
            "vocoder_s_per_audio_s.scene", "step_issue_ms.scene",
            "host_wait_share.scene", "prefill_ms.scene",
            "vocoder_exact_share.scene"}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["metrics"]["mfu.v2scene"]["value"] < 100


def test_roofline_against_a_hand_count():
    """``dit_forward_ops`` and ``call_flops`` at the small configuration,
    against the multiply-adds counted by hand."""
    cfg = json.loads((DATA / "tiny.v2.json").read_text())
    n = 10
    d, m, h, i, st, c = 32, 80, 32, 64, 16, 32
    merge = 2 * n * (d + 2 * m + st) * d + 2 * n * c * d
    block = 2 * n * (4 * d * d + 3 * d * i) + 4 * n * n * d
    skips = 2 * (2 * n * 2 * d * d)            # blocks 3 and 4 receive
    head = 2 * n * (d + m) * d + 2 * n * d * h
    wn = 3 * 2 * n * h * 2 * h * 5 + 2 * (2 * n * h * 2 * h) + 2 * n * h * h
    tail = 2 * n * d * h + 2 * n * h * h + 2 * n * h * m
    hand = merge + 5 * block + skips + head + wn + tail
    assert v2_roofline.dit_forward_ops(cfg, n) == hand
    g = cfg["gpt"]
    one = v2_roofline.call_flops(cfg, [5], [0], 2, 1, [], 0, 3)
    from perfbench.roofline import gpt_prefill_ops
    assert one == gpt_prefill_ops(g, 34 + 5 + 3)
    two = v2_roofline.call_flops(cfg, [5], [0], 2, 1, [40], 30, 3)
    from perfbench.roofline import bigvgan_ops_per_frame
    assert two - one == 6 * v2_roofline.dit_forward_ops(cfg, 40) \
        + 10 * bigvgan_ops_per_frame(cfg["vocoder"]["bigvgan"])


def _step_skipped(monkeypatch):
    """Every call's second Euler step adds nothing."""
    orig, count = s2m_mod.forward, [0]

    def forward(*a, **k):
        count[0] += 1
        v = orig(*a, **k)
        return torch.zeros_like(v) if count[0] % 3 == 2 else v
    monkeypatch.setattr(s2m_mod, "forward", forward)


def _guidance_dropped(monkeypatch):
    """The unconditioned rows give the conditioned rows' velocity."""
    orig = s2m_mod.forward

    def forward(*a, **k):
        v = orig(*a, **k)
        h = v.shape[0] // 2
        return torch.cat([v[:h], v[:h]])
    monkeypatch.setattr(s2m_mod, "forward", forward)


def _prompt_not_held(monkeypatch):
    """The prompt frames of x are left to move after each step."""
    orig = v2_mod.guided_euler
    monkeypatch.setattr(v2_mod, "guided_euler",
                        lambda *a, hold=None, **k: orig(*a, **k))


def _emotion_left_out(monkeypatch):
    """The GPT's conditioning rows without the emotion vector."""
    orig = gpt_model.v2_conds
    monkeypatch.setattr(gpt_model, "v2_conds",
                        lambda p, spk, emo: orig(p, spk, 0 * emo))


def _noise_shifted(monkeypatch):
    """Row i draws row i + 1's noise (seed + i + 1)."""
    orig = v2_mod.IndexTTS2.draw_noise
    monkeypatch.setattr(v2_mod.IndexTTS2, "draw_noise",
                        lambda self, durs, n, seed: orig(self, durs, n,
                                                         seed + 1))


def _code_altered(monkeypatch):
    """The first row's sixth code is replaced by one the row has served
    before (the repetition penalty puts it far below the kept set)."""
    orig = decode_mod.generate_beam_sample

    def altered(*a, **k):
        res = orig(*a, **k)
        codes = res.codes.clone()
        row = codes[0]
        row[5] = row[0] if row[5] != row[0] else row[1]
        return res._replace(codes=codes)
    monkeypatch.setattr(decode_mod, "generate_beam_sample", altered)


@pytest.mark.parametrize("fault", [_step_skipped, _guidance_dropped,
                                   _prompt_not_held, _emotion_left_out,
                                   _noise_shifted, _code_altered],
                         ids=["step-skipped", "guidance-dropped",
                              "prompt-not-held", "emotion-left-out",
                              "noise-shifted", "code-altered"])
def test_fault_makes_correct_false(v2_root, monkeypatch, fault):
    fault(monkeypatch)
    r, lines = run_tiny(v2_root, CELL, seconds=0.5)
    assert r["correct"] is False, lines[-4:]
    assert any(not np.isfinite(c["value"]) or c["value"] > c["limit"]
               for c in r["checks"].values()), lines


def test_control_fails_at_small_size(v2_root, tmp_path):
    """The control (the reference in bfloat16) in the program's place reads
    above a limit, where the program reads inside them."""
    torch.set_num_threads(2)
    cell = harness.load_cell(v2_root, CELL)
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
