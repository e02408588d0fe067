"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

Everything that belongs to a configuration, a traffic mix, a cell or a
metric is found by its name in ``BENCHMARK.json``: the configuration's
file, the mix ``perfbench/traffic/<traffic>.json``, the cell's limits of
``correct`` ``perfbench/limits/<cell>.json`` and the reader
``perfbench/metrics/<metric>.py`` of each metric the cell reports.
"""
from __future__ import annotations

import contextlib
import gc
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
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import check, traffic, weights
from perfbench import trace as trace_mod
from perfbench.reference import Reference

ROOT = Path(__file__).resolve().parent.parent
# top-level module names the process that prints the result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "index_tts_dubbing_tpu")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    mix = traffic.load(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    limits = json.loads((root / "perfbench" / "limits" /
                         f"{workload}.json").read_text())["limits"]
    mine = lambda m: workload in m.get("workloads", [workload])
    return Cell(workload, int(w["chips"]), config, mix, limits,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


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


def engine_config(config: Dict[str, Any]):
    from index_tts_dubbing_tpu_torch.config import (BigVGANConfig,
                                                    EngineConfig, GPTConfig,
                                                    MelConfig)
    b = dict(config["bigvgan"])
    for key in ("upsample_rates", "upsample_kernel_sizes",
                "resblock_kernel_sizes"):
        b[key] = tuple(b[key])
    b["resblock_dilation_sizes"] = tuple(tuple(d) for d in
                                         b["resblock_dilation_sizes"])
    return EngineConfig(mel=MelConfig(**config["mel"]),
                        gpt=GPTConfig(**config["gpt"]),
                        bigvgan=BigVGANConfig(**b),
                        version=config["version"])


def write_prompt(path: Path, wav: np.ndarray, sample_rate: int) -> None:
    import wave
    pcm = np.clip(wav * 32767.0, -32767, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


class Program:
    """The system under test: the port's engine on the benchmark's weights
    and prompt."""

    def __init__(self, cell: Cell, seed: int, device, workdir: Path):
        from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS
        cfg = cell.config
        self.cell = cell
        self.dtype = cfg["dtype"]
        params = weights.make(cfg, seed, device, DTYPES[self.dtype])
        self.tts = IndexTTS(config=engine_config(cfg), params=params,
                            is_fp16=self.dtype == "bfloat16", device=device,
                            seed=int(seed), verbose_init=False)
        sr = cfg["mel"]["sample_rate"]
        self.prompt = workdir / "prompt.wav"
        write_prompt(self.prompt, traffic.prompt_wav(cell.mix, seed, sr), sr)
        self.cuda = torch.device(device).type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def serve(self, call: traffic.Call) -> Dict[str, Any]:
        tts, entry = self.tts, self.cell.mix["entry"]
        rec: Dict[str, Any] = {"index": call.index, "slot": call.slot,
                               "cap": call.cap,
                               "texts": call.texts, "error": None}
        rec["t0"] = time.perf_counter()
        try:
            with open(os.devnull, "w") as sink, \
                    contextlib.redirect_stdout(sink):
                if entry == "infer_fast":
                    _, wav = tts.infer_fast(str(self.prompt), call.texts[0],
                                            **call.kwargs)
                    wav = wav[:, 0]
                else:
                    outs = tts.infer_batch(str(self.prompt), call.texts,
                                           **call.kwargs)
                    wav = np.concatenate([w[:, 0] for _, w in outs])
        except Exception as e:                     # counted, not fatal
            rec["t1"] = time.perf_counter()
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["audio_s"] = 0.0
            return rec
        rec["t1"] = time.perf_counter()
        lt = tts.last_times
        res = tts.last_fused_res if tts.last_path == "fused" else None
        rec.update(audio_s=lt.audio_seconds, gpt_gen=lt.gpt_gen,
                   bigvgan=lt.bigvgan, steps=lt.decode_steps,
                   beams=tts._num_beams, wav=wav, path=tts.last_path,
                   frames=[int(f) for f in tts.last_sentence_frames],
                   codes=None if res is None else res.codes[:len(call.texts)])
        return rec

    def free(self) -> None:
        del self.tts
        gc.collect()
        torch.cuda.empty_cache()


def run_window(prog: Program, calls, seconds: float
               ) -> tuple:
    records = []
    t_start = time.perf_counter()
    for call in calls:
        rec = prog.serve(call)
        records.append(rec)
        if rec["t1"] - t_start >= seconds:
            break
    return records, records[-1]["t1"] - t_start


def profiled(prog: Program, calls, n: int, acts, workdir: Path) -> dict:
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


def traced_stretch(prog: Program, calls, n: int, workdir: Path
                   ) -> tuple:
    """Two stretches of ``n`` more calls each. The first traces the device
    alone, which costs the host little: busy time, device ops and K2's
    time, with K2's launch shapes recorded from the benchmark's side. The
    second traces the host too, only to name the idle gaps by host op."""
    from index_tts_dubbing_tpu_torch.engine import vocoder as voc_mod
    launches: List[tuple] = []
    orig = voc_mod.resblock_cmajor

    def recording(x, *args, **kwargs):
        k = args[5] if len(args) > 5 else kwargs["k"]
        launches.append((x.shape[0], x.shape[1], x.shape[2], int(k),
                         "bfloat16" if x.dtype == torch.bfloat16
                         else "float32"))
        return orig(x, *args, **kwargs)

    cpu, cuda = (torch.profiler.ProfilerActivity.CPU,
                 torch.profiler.ProfilerActivity.CUDA)
    voc_mod.resblock_cmajor = recording
    try:
        red = profiled(prog, calls, n, [cuda] if prog.cuda else [cpu],
                       workdir)
    finally:
        voc_mod.resblock_cmajor = orig
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
    for r in records:
        if r.get("codes") is not None:
            r["codes"] = r["codes"].cpu().numpy()


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_process: float, root: Path = ROOT, device: str = "cuda",
        chip_check: Callable[[int], None] = require_chips
        ) -> Tuple[Dict[str, Any], List[str]]:
    """One run: (the result line's object, the lines for standard error,
    which end with the compared numbers beside their limits)."""
    cell = load_cell(root, workload)
    chip_check(cell.chips)
    cfg, mix = cell.config, cell.mix
    torch.manual_seed(int(seed))
    workdir = Path(tempfile.mkdtemp(prefix="perfbench-",
                                    dir=os.environ.get("TMPDIR")))
    try:
        prog = Program(cell, seed, device, workdir)
        for call in traffic.warmup_calls(mix, seed):
            rec = prog.serve(call)
            if rec["error"]:
                raise RuntimeError(f"warm-up call failed: {rec['error']}")
        prog.sync()
        setup_s = time.perf_counter() - t_process
        calls = traffic.calls(mix, seed)
        records, window_s = run_window(prog, calls, seconds)
        data = RunData(cell, records, window_s, setup_s, prog.dtype)
        if trace:
            data.trace, data.k2_launches = traced_stretch(
                prog, calls, int(mix.get("trace_calls", 1)), workdir)
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
        params = weights.cast(weights.make(cfg, seed, device,
                                           DTYPES[cfg["dtype"]]),
                              torch.float32)
        ref = Reference(params, cfg, torch.float32)
        ref.set_prompt(prompt)
        read = check.readings(ref, records, idx, cfg, mix["decode"], seed)
        del ref, params
        checks = check.judge(read, cell.limits)
        failed = sum(r["error"] is not None for r in records)
        correct = (all(c["ok"] for c in checks.values())
                   and read["tokens"] > 0)

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
            ["call slot cap wall_s audio_s steps gpt_gen_s bigvgan_s"]
            + [f"{r['index']} {r['slot']} {r['cap']} "
               f"{r['t1'] - r['t0']:.4f} {r['audio_s']:.3f} "
               f"{r.get('steps', 0)} {r.get('gpt_gen', 0.0):.4f} "
               f"{r.get('bigvgan', 0.0):.4f}" + (f" {r['error']}"
                                                 if r["error"] else "")
               for r in records]
            + [f"calls {len(records)} window_s {window_s} setup_s {setup_s}",
             f"power {dev_info['power']}",
             f"compared calls {read['calls']} served codes "
             f"{read['tokens']} wav_unit {read['wav_unit']}"]
            + [f"{k} {v['value']} limit {v['limit']}"
               for k, v in checks.items()])
        return result, lines
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
