"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

Everything that belongs to a configuration, a traffic mix, a cell or a
metric is found by its name in ``BENCHMARK.json``: the configuration's
file, the mix ``perfbench/traffic/<traffic>.json``, the cell's limits of
``correct`` ``perfbench/limits/<cell>.json`` and the reader
``perfbench/metrics/<metric>.py`` of each metric the cell reports. What
belongs to a model (the program, its calls, its weights, its plain
reference and control, what its traced stretch records) is found by the
family the configuration's file names, ``perfbench/families/<family>.py``
(``perfbench/families/__init__.py``). So a model of another family, a
configuration, a mix and a metric are each added by new files and entries
alone.
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import check, families, traffic
from perfbench import trace as trace_mod

ROOT = Path(__file__).resolve().parent.parent
# top-level module names the process that prints the result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "index_tts_dubbing_tpu")


class NoChip(RuntimeError):
    pass


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]        # the configuration's file
    mix: Dict[str, Any]           # the traffic mix's file
    limits: Dict[str, float]      # the cell's limits of ``correct``
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    family: ModuleType            # the configuration's model family


@dataclass
class RunData:
    """What a metric's reader reads."""
    cell: Cell
    records: List[Dict[str, Any]]      # the window's calls
    window_s: float
    setup_s: float
    dtype: str
    trace: Optional[Dict[str, Any]] = None
    k2_launches: List[tuple] = field(default_factory=list)


def load_cell(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"cells: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    family = families.of(config, root)
    mix = traffic.load(root / "perfbench" / "traffic" / f"{w['traffic']}.json",
                       family)
    limits = json.loads((root / "perfbench" / "limits" /
                         f"{workload}.json").read_text())["limits"]
    mine = lambda m: workload in m.get("workloads", [workload])
    return Cell(workload, int(w["chips"]), config, mix, limits,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)], family)


def reader(root: Path, name: str) -> Callable[[RunData], Optional[float]]:
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def require_chips(n: int) -> None:
    if not torch.cuda.is_available():
        raise NoChip("no CUDA device")
    if torch.cuda.device_count() < n:
        raise NoChip(f"{torch.cuda.device_count()} CUDA devices, the cell "
                     f"needs {n}")


def write_prompt(path: Path, wav: np.ndarray, sample_rate: int) -> None:
    import wave
    pcm = np.clip(wav * 32767.0, -32767, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def Program(cell: Cell, seed: int, device, workdir: Path):
    """The system under test: the cell's family's program on weights drawn
    from the seed and the benchmark's prompt."""
    return cell.family.Program(cell, seed, device, workdir)


def run_window(prog, calls, seconds: float
               ) -> tuple:
    records = []
    t_start = time.perf_counter()
    for call in calls:
        rec = prog.serve(call)
        records.append(rec)
        if rec["t1"] - t_start >= seconds:
            break
    return records, records[-1]["t1"] - t_start


def profiled(prog, calls, n: int, acts, workdir: Path) -> dict:
    """``n`` more calls under the profiler with activities ``acts``: the
    trace reduced, and the wall of the stretch."""
    prog.sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _, call in zip(range(n), calls):
            prog.serve(call)
        prog.sync()
        wall = time.perf_counter() - t0
    out = workdir / "trace.json"
    prof.export_chrome_trace(str(out))
    del prof
    red = trace_mod.reduce(out)
    out.unlink()
    red["window_s"] = wall
    return red


def traced_stretch(prog, calls, n: int, workdir: Path,
                   hook: Callable) -> tuple:
    """Two stretches of ``n`` more calls each. The first traces the device
    alone, which costs the host little: busy time, device ops and kernel
    times, with the kernel launches that the family's ``hook`` records from
    the benchmark's side. The second traces the host too, only to name the
    idle gaps by host op."""
    cpu, cuda = (torch.profiler.ProfilerActivity.CPU,
                 torch.profiler.ProfilerActivity.CUDA)
    with hook() as launches:
        red = profiled(prog, calls, n, [cuda] if prog.cuda else [cpu],
                       workdir)
    red["idle_gaps"] = profiled(prog, calls, n,
                                [cpu, cuda] if prog.cuda else [cpu],
                                workdir)["idle_gaps"]
    return red, launches


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"unknown ({type(e).__name__})"


def host_codes(records: List[Dict[str, Any]]) -> None:
    """Every tensor the records hold (the served codes) moved to the host,
    as a numpy array, before the program is freed."""
    for r in records:
        for k, v in r.items():
            if isinstance(v, torch.Tensor):
                r[k] = v.cpu().numpy()


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_process: float, root: Path = ROOT, device: str = "cuda",
        chip_check: Callable[[int], None] = require_chips
        ) -> Tuple[Dict[str, Any], List[str]]:
    """One run: (the result line's object, the lines for standard error,
    which end with the compared numbers beside their limits)."""
    cell = load_cell(root, workload)
    chip_check(cell.chips)
    cfg, mix, fam = cell.config, cell.mix, cell.family
    torch.manual_seed(int(seed))
    workdir = Path(tempfile.mkdtemp(prefix="perfbench-",
                                    dir=os.environ.get("TMPDIR")))
    try:
        prog = Program(cell, seed, device, workdir)
        for call in traffic.warmup_calls(mix, seed, fam):
            rec = prog.serve(call)
            if rec["error"]:
                raise RuntimeError(f"warm-up call failed: {rec['error']}")
        prog.sync()
        setup_s = time.perf_counter() - t_process
        calls = traffic.calls(mix, seed, fam)
        records, window_s = run_window(prog, calls, seconds)
        data = RunData(cell, records, window_s, setup_s, prog.dtype)
        if trace:
            data.trace, data.k2_launches = traced_stretch(
                prog, calls, int(mix.get("trace_calls", 1)), workdir,
                fam.trace_hook)
        dev_info: Dict[str, Any] = {"platform": "gpu" if device == "cuda"
                                    else device, "count": cell.chips}
        if device == "cuda":
            dev_info["kind"] = torch.cuda.get_device_name(0)
            dev_info["memory_peak_bytes"] = int(
                torch.cuda.max_memory_allocated(0))
        if trace:
            dev_info["busy_s"] = data.trace["busy_s"]
            dev_info["window_s"] = data.trace["window_s"]
        dev_info["power"] = power_limit() if device == "cuda" else "cpu"
        host_codes(records)
        prompt = prog.prompt
        prog.free()
        del prog

        # the check, once the window has closed and the program is freed
        idx = check.sample(records, seed, int(mix.get("check_extra", 2)))
        read = fam.compare(records, idx, cfg, mix, seed, prompt, device)
        checks = check.judge(read, cell.limits)
        failed = sum(r["error"] is not None for r in records)
        correct = (all(c["ok"] for c in checks.values())
                   and read["compared"] > 0)

        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = reader(root, m["name"])(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result: Dict[str, Any] = {"correct": bool(correct),
                                  "attempted": len(records),
                                  "failed": failed, "metrics": metrics,
                                  "device": dev_info}
        if trace:
            result["breakdown"] = {"device_ops": data.trace["device_ops"],
                                   "idle_gaps": data.trace["idle_gaps"]}
        result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                            for k, v in checks.items()}
        lines = (
            [f"call slot cap wall_s audio_s {fam.CALL_COLUMNS}"]
            + [f"{r['index']} {r['slot']} {r['cap']} "
               f"{r['t1'] - r['t0']:.4f} {r['audio_s']:.3f} "
               f"{fam.call_columns(r)}" + (f" {r['error']}"
                                           if r["error"] else "")
               for r in records]
            + [f"calls {len(records)} window_s {window_s} setup_s {setup_s}",
             f"power {dev_info['power']}", fam.compared_line(read)]
            + [f"{k} {v['value']} limit {v['limit']}"
               for k, v in checks.items()])
        return result, lines
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
