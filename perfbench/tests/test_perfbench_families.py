"""The model-family seam on the CPU: a family of another shape (no codes,
no beam sampling, no ``decode`` block) added to a checkout by new files and
entries alone runs through ``harness.run`` with its own mix, reference and
``correct``; the two spellings of IndexTTS give one result; the generic
side imports no model."""
import ast
import json
import textwrap

import pytest

from perfbench import families, harness
from perfbench.tests.conftest import ROOT, run_tiny

TOY = textwrap.dedent('''
    """A toy family: a seeded two-layer map from the prompt's frames to a
    wav, served from ``entry: "toy"``; no codes, no decode settings."""
    import contextlib
    import time

    import numpy as np
    import torch

    from perfbench import harness, traffic

    FRAME = 64
    OFFSET = {offset}
    CALL_COLUMNS = "samples"


    def check_mix(mix, path):
        if mix["entry"] != "toy":
            raise ValueError(f"{{path}}: unknown entry {{mix['entry']!r}}")


    def call_kwargs(mix, slot):
        return {{"frames": int(mix["slots"][slot]["cap"])}}


    def _weights(cfg, seed, dtype):
        g = torch.Generator().manual_seed(int(seed))
        h = cfg["hidden"]
        w1 = torch.randn(FRAME, h, generator=g, dtype=torch.float64)
        w2 = torch.randn(h, FRAME, generator=g, dtype=torch.float64)
        return (w1 / FRAME ** 0.5).to(dtype), (w2 / h ** 0.5).to(dtype)


    def _map(wav, frames, w1, w2):
        x = torch.as_tensor(np.resize(wav, frames * FRAME)).reshape(
            frames, FRAME).to(w1.dtype)
        return (torch.tanh(x @ w1) @ w2).reshape(-1)


    class Program:
        def __init__(self, cell, seed, device, workdir):
            cfg = cell.config
            self.dtype, self.sr, self.cuda = cfg["dtype"], cfg["sr"], False
            self.w = _weights(cfg, seed, torch.float32)
            self.wav = traffic.prompt_wav(cell.mix, seed, self.sr)
            self.prompt = workdir / "prompt.wav"
            harness.write_prompt(self.prompt, self.wav, self.sr)

        def sync(self):
            pass

        def serve(self, call):
            rec = {{"index": call.index, "slot": call.slot, "cap": call.cap,
                    "texts": call.texts, "error": None,
                    "t0": time.perf_counter()}}
            wav = _map(self.wav, call.kwargs["frames"], *self.w) + OFFSET
            rec.update(t1=time.perf_counter(), wav=wav.numpy(),
                       audio_s=wav.numel() / self.sr)
            return rec

        def free(self):
            del self.w


    def control(params32, cfg):
        return tuple(w.to(torch.bfloat16) for w in params32)


    def compare(records, idx, cfg, mix, seed, prompt, device,
                as_control=False):
        w = _weights(cfg, seed, torch.float64)
        prompt_wav = traffic.prompt_wav(mix, seed, cfg["sr"])
        err, n = 0.0, 0
        for i in idx:
            r = records[i]
            want = _map(prompt_wav, r["cap"], *w).numpy()
            got = (_map(prompt_wav, r["cap"],
                        *control(_weights(cfg, seed, torch.float32), cfg))
                   .double().numpy() if as_control else r["wav"])
            err = max(err, float(np.linalg.norm(got - want)
                                 / np.linalg.norm(want)))
            n += want.size
        return {{"wav_err": err, "compared": n, "calls": len(idx)}}


    def trace_hook():
        return contextlib.nullcontext([])


    def call_columns(r):
        return str(len(r.get("wav", ())))


    def compared_line(read):
        return f"compared calls {{read['calls']}} samples {{read['compared']}}"
''')


def _add_toy(root, offset: float) -> None:
    """The toy family, its configuration, mix, limits, cell and metric:
    new files and new entries only."""
    (root / "perfbench" / "families" / "toy.py").write_text(
        TOY.format(offset=offset))
    (root / "toy.json").write_text(json.dumps(
        {"family": "toy", "dtype": "float32", "sr": 8000, "hidden": 32}))
    (root / "perfbench" / "traffic" / "toymix.json").write_text(json.dumps(
        {"entry": "toy", "prompt_seconds": 0.5,
         "slots": [{"cap": 8, "chars": [4]}, {"cap": 24, "chars": [6]}]}))
    (root / "perfbench" / "limits" / "toy.tiny.json").write_text(
        json.dumps({"limits": {"wav_err": 1e-5}}))
    (root / "perfbench" / "metrics" / "samples_per_s.toy.py").write_text(
        "def read(data):\n"
        "    return sum(r['wav'].size for r in data.records) "
        "/ data.window_s\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "tests",
                             "file": "toy.json", "reduced": [],
                             "why": "a family of another shape"})
    bench["workloads"].append({"name": "toy.tiny", "config": "toy",
                               "traffic": "toymix", "chips": 1,
                               "why": "a family of another shape"})
    bench["end_to_end"].append({"name": "samples_per_s.toy",
                                "unit": "samples/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["toy.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("offset,correct", [(0.0, True), (0.01, False)],
                         ids=["sound", "offset"])
def test_a_family_added_by_new_files(tiny_root, offset, correct):
    _add_toy(tiny_root, offset)
    r, lines = run_tiny(tiny_root, "toy.tiny", seconds=0.25)
    assert r["correct"] is correct, lines[-3:]
    assert r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["metrics"]) == {"setup_s", "samples_per_s.toy"}
    assert set(r["checks"]) == {"wav_err"}
    assert lines[0] == "call slot cap wall_s audio_s samples"
    assert lines[-2].startswith("compared calls ")
    assert lines[-1].startswith("wav_err ") and "limit" in lines[-1]


def test_control_of_the_toy_fails(tiny_root):
    """The toy's control (bfloat16 weights) reads above its limit."""
    _add_toy(tiny_root, 0.0)
    cell = harness.load_cell(tiny_root, "toy.tiny")
    read = cell.family.compare([{"cap": 24}], [0], cell.config, cell.mix,
                               3, None, "cpu", as_control=True)
    assert read["wav_err"] > 1e-5 and read["compared"] == 24 * 64


def test_two_spellings_of_indextts_give_one_result(tiny_root):
    """``tiny.f32`` without ``family`` and with ``"family": "indextts"``:
    the same checks and the same metric names. A window shorter than one
    call holds the same single call in both runs."""
    cfg = json.loads((tiny_root / "tiny.f32.json").read_text())
    assert "family" not in cfg
    bare = run_tiny(tiny_root, "line.tiny", seconds=0.01)[0]
    (tiny_root / "tiny.f32.json").write_text(
        json.dumps(dict(cfg, family="indextts")))
    named = run_tiny(tiny_root, "line.tiny", seconds=0.01)[0]
    assert bare["attempted"] == named["attempted"] == 1
    assert bare["correct"] is named["correct"] is True
    assert bare["checks"] == named["checks"]
    assert set(bare["metrics"]) == set(named["metrics"])


def test_unknown_family_is_refused(tiny_root):
    cfg = json.loads((tiny_root / "tiny.f32.json").read_text())
    (tiny_root / "tiny.f32.json").write_text(
        json.dumps(dict(cfg, family="nosuch")))
    with pytest.raises(ValueError, match="nosuch"):
        harness.load_cell(tiny_root, "line.tiny")
    with pytest.raises(ValueError, match="family"):
        families.load("../harness", ROOT)


@pytest.mark.parametrize("name", ["harness.py", "traffic.py",
                                  "calibrate.py"])
def test_the_generic_side_imports_no_model(name):
    """Everything a model needs reaches these files through its family."""
    tree = ast.parse((ROOT / "perfbench" / name).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    mods |= {f"perfbench.{a.name}" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module == "perfbench"
             for a in n.names}
    assert not {m for m in mods if m.startswith(
        ("index_tts_dubbing_tpu_torch", "perfbench.reference",
         "perfbench.weights", "perfbench.families."))}, mods
