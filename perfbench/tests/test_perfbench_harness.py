"""The harness end to end on the CPU at the tests' small size: the result
line's schema, a configuration, a mix and a metric added by new files and
entries alone (a model family too: ``test_perfbench_families.py``), and
the look for a chip."""
import json
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT, run_tiny

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def _bench(root):
    return json.loads((root / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload,trace", [("line.tiny", False),
                                            ("line.tiny", True),
                                            ("scene.tiny", False)])
def test_result_line_schema(tiny_root, workload, trace):
    r, lines = run_tiny(tiny_root, workload, trace=trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    bench = _bench(tiny_root)
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"] for m in bench[kind]
            if workload in m.get("workloads", [workload])}
    got = {k: v["unit"] for k, v in r["metrics"].items()}
    # on the CPU the device readers find nothing to read and say nothing
    assert got == {k: u for k, u in want.items()
                   if not k.startswith(("idle_share", "k2_roofline",
                                        "graph_step_share"))}
    for v in r["metrics"].values():
        assert isinstance(v["value"], float) and v["value"] > 0
    assert r["device"]["platform"] == "cpu" and r["device"]["count"] == 1
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(r["checks"]) == {"code_gap", "wav_err"}
    for name, c in r["checks"].items():
        assert c["value"] <= c["limit"]
        assert any(line.startswith(f"{name} ") and "limit" in line
                   for line in lines[-2:])
    json.dumps(r)


def test_new_entries_need_no_edit(tiny_root):
    """A throwaway configuration, mix and metric of the IndexTTS family:
    new files and new entries only, and the harness finds and reports them.
    A model of another family is added the same way, with its family's
    file (``test_perfbench_families.py``)."""
    cfg = json.loads((tiny_root / "tiny.f32.json").read_text())
    cfg["gpt"]["layers"] = 1
    (tiny_root / "tiny1.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny_root / "perfbench" / "traffic" /
                      "tinyline.json").read_text())
    mix["slots"] = mix["slots"][-1:]
    (tiny_root / "perfbench" / "traffic" / "oneslot.json").write_text(
        json.dumps(mix))
    (tiny_root / "perfbench" / "metrics" / "calls_per_s.throwaway.py"
     ).write_text("def read(data):\n"
                  "    return len(data.records) / data.window_s\n")
    bench = _bench(tiny_root)
    bench["configs"].append({"name": "tiny1", "source": "tests",
                             "file": "tiny1.json", "reduced": ["gpt"],
                             "why": "throwaway"})
    bench["workloads"].append({"name": "one.tiny1", "config": "tiny1",
                               "traffic": "oneslot", "chips": 1,
                               "why": "throwaway"})
    bench["end_to_end"].append({"name": "calls_per_s.throwaway",
                                "unit": "calls/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["one.tiny1"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    (tiny_root / "perfbench" / "limits" / "one.tiny1.json").write_text(
        json.dumps({"limits": {"code_gap": 2e-4, "wav_err": 1e-3}}))
    r, _ = run_tiny(tiny_root, "one.tiny1")
    assert set(r["metrics"]) == {"setup_s", "calls_per_s.throwaway"}
    assert r["correct"] is True


def test_no_chip_no_result(tmp_path):
    """Without CUDA the command exits non-zero and prints no result."""
    p = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"),
                        "--workload", "line.v15-bf16", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr or "device" in p.stderr


def test_require_chips(monkeypatch):
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(harness.torch.cuda, "device_count", lambda: 1)
    harness.require_chips(1)
    with pytest.raises(harness.NoChip):
        harness.require_chips(4)
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.NoChip):
        harness.require_chips(1)


def test_alone_the_benchmark_fails(tmp_path):
    """In a directory with only BENCHMARK.json and perfbench/, no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "line.v15-bf16", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
