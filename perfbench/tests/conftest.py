"""Shared set-up of the benchmark's tests.

``tiny_root`` builds a checkout-like directory of its own that holds only
new files and entries: a configuration (``tiny.f32``, IndexTTS's structure
at the port's small test widths, float32), two traffic mixes and the
benchmark's own metric readers and model families, with a
``BENCHMARK.json`` naming them. The harness runs from it on the CPU. The
``card`` marker is for tests that need a CUDA device; each decides inside
itself whether there is one.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
DATA = Path(__file__).resolve().parent / "data"
SEED = 2**31 + 7


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


def tiny_bench() -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny.f32", "source": "perfbench tests",
                         "file": "tiny.f32.json", "reduced": ["gpt"],
                         "why": "small"}]
    bench["workloads"] = [
        {"name": "line.tiny", "config": "tiny.f32", "traffic": "tinyline",
         "chips": 1, "why": "small"},
        {"name": "scene.tiny", "config": "tiny.f32", "traffic": "tinyscene",
         "chips": 1, "why": "small"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "line" if "line" in m["name"] else "scene"
            m["workloads"] = [f"{kind}.tiny"]
    return bench


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path / "checkout")


def make_tiny_root(root: Path) -> Path:
    (root / "perfbench" / "traffic").mkdir(parents=True)
    shutil.copytree(ROOT / "perfbench" / "metrics",
                    root / "perfbench" / "metrics")
    shutil.copytree(ROOT / "perfbench" / "families",
                    root / "perfbench" / "families",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for mix in ("tinyline", "tinyscene"):
        shutil.copy(DATA / f"{mix}.json",
                    root / "perfbench" / "traffic" / f"{mix}.json")
    shutil.copy(DATA / "tiny.f32.json", root / "tiny.f32.json")
    (root / "perfbench" / "limits").mkdir()
    for cell in ("line.tiny", "scene.tiny"):
        shutil.copy(DATA / "tiny.limits.json",
                    root / "perfbench" / "limits" / f"{cell}.json")
    (root / "BENCHMARK.json").write_text(json.dumps(tiny_bench()))
    return root


def run_tiny(root: Path, workload: str, trace: bool = False,
             seconds: float = 4.0, seed: int = SEED) -> tuple:
    """One harness run on the CPU, the look for a chip skipped: (result,
    standard error's lines)."""
    import time

    import torch
    from perfbench import harness
    torch.set_num_threads(2)
    return harness.run(workload, seed, seconds, trace, time.perf_counter(),
                       root=root, device="cpu", chip_check=lambda n: None)
