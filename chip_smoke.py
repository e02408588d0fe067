#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (index_tts_dubbing_tpu_torch) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed with its wall seconds; any failure exits non-zero:

1. device  - a CUDA device must exist; prints nvidia-smi's name and power limit.
2. build   - compiles the kernels (csrc/*.cu, one nvcc call) into
             index_tts_dubbing_tpu_torch/_build/.
3. kernels - holds K1 (snake_cmajor) and K2 (resblock_cmajor) against their
             plain PyTorch versions over whole tensors at the vocoder's
             main-path shapes, in float32 and bfloat16, and times both.
4. main    - full-width EngineConfig(), bf16 random weights from seed 0, a
             3 s numpy prompt; three IndexTTS.infer_fast(num_beams=1)
             requests (warm-up, one sentence, three sentences padded to a
             batch bucket with a dead row). Checks each output's length,
             finiteness and that both kernels launched; then holds the
             windowed vocoder on the kernels against the exact route.

Then one JSON line describing the kernels and, last, the device line.
Float32 convs and products run without TF32 throughout (set below), so the
plain versions are float32 references.
"""
import argparse
import faulthandler
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from index_tts_dubbing_tpu_torch.config import EngineConfig
from index_tts_dubbing_tpu_torch.engine import vocoder as voc_mod
from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS
from index_tts_dubbing_tpu_torch.ops import cuda_lib
from index_tts_dubbing_tpu_torch.ops import resblock_cmajor as k2
from index_tts_dubbing_tpu_torch.ops import snake_cmajor as k1
from index_tts_dubbing_tpu_torch.utils.audio import write_wav

WATCHDOG_S = 480
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # dense bf16 tensor cores
WINDOW_BATCH = 4                 # windows per vocoder call in the checks
# K1 per window batch: 18 activations in each C > 128 stage, plus act_post
K1_SHAPES = [(768, 576, 18), (384, 2304, 18), (192, 9216, 18), (24, 147456, 1)]
# K2 per window batch: one resblock per kernel size in each C <= 128 stage
K2_SHAPES = [(c, t, k) for c, t in ((96, 36864), (48, 73728), (24, 147456))
             for k in (3, 7, 11)]
DILS = (1, 3, 5)
# |kernel - plain| <= TOL * max(1, max|plain|): float32 differs only in the
# summation order of up to six chained k·C-term convs; bfloat16 outputs (and
# conv inputs rounded to bfloat16) may land one or two ulps (2^-8 relative)
# apart after a float32 difference upstream.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# windowed vocoder on the kernels vs the exact route, float wav in [-1, 1]:
# float32 summation order over ~40 chained full-width convs
VOCODER_TOL = 1e-3
TEXTS = [
    "The quick brown fox jumps over the lazy dog near the river bank.",
    "Hello there, this is the first slice of the port speaking on the card.",
    "Zero shot speech synthesis turns a short prompt into a voice that reads "
    "any text aloud. The decoder samples mel codes one token at a time from "
    "the language model. The vocoder then turns those codes into a waveform "
    "at twenty four kilohertz.",
]


def phase(name: str, t0: float, detail: str = "") -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s {detail}".rstrip(),
          flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds of one ``fn()``: a CUDA graph of one call,
    replayed ``reps`` times between two events, so host-side launch overhead
    (which the eager loop would add to a short kernel) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, fp32_ops: float, bf16_ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = fp32_ops / FP32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


ACT_OPS = 58    # float32 ops per activation output: 2×6-tap up, 2 snakes, 12-tap down


def check_kernels(gen: torch.Generator):
    """Each kernel vs its plain version at the main-path shapes; returns
    per-kernel timings (float32, one window batch) and errors."""
    dev = "cuda"
    rand = lambda *s: torch.randn(*s, generator=gen, device=dev)
    out = {"snake_cmajor": [], "resblock_cmajor": []}
    for dt in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dt).element_size()
        for c, t, per_batch in K1_SHAPES:
            x = rand(WINDOW_BATCH, c, t).to(dt)
            al, be = rand(c) * 0.3, rand(c) * 0.3
            ref = k1.snake_cmajor_plain(x, al, be, True).float()
            got = k1.snake_cmajor(x, al, be, True).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            lim = TOL[dt] * max(1.0, ref.abs().max().item())
            if not err <= lim:
                raise AssertionError(f"K1 {dt} C={c} T={t}: err {err} > {lim}")
            row = {"dtype": str(dt), "C": c, "T": t, "per_batch": per_batch,
                   "max_abs_err": err, "tol": lim}
            if dt == torch.float32:
                row["ms"] = cuda_ms(lambda: k1.snake_cmajor(x, al, be, True), 10)
                row["plain_ms"] = cuda_ms(
                    lambda: k1.snake_cmajor_plain(x, al, be, True), 3)
                n = WINDOW_BATCH * c * t
                row["bound_ms"], row["bound_by"] = bound_ms(
                    2 * n * es + 8 * c, n * ACT_OPS)
            out["snake_cmajor"].append(row)
        for c, t, k in K2_SHAPES:
            conv = lambda: {"w": rand(k, c, c) * 0.1, "b": rand(c) * 0.1}
            rb = {"convs1": [conv() for _ in range(3)],
                  "convs2": [conv() for _ in range(3)],
                  "acts": [{"alpha": rand(c) * 0.3, "beta": rand(c) * 0.3}
                           for _ in range(6)]}
            w = k2.pack_resblock(rb, EngineConfig().bigvgan, dt)
            x = (rand(WINDOW_BATCH, c, t) * 0.5).to(dt)
            ref = k2.resblock_cmajor_plain(x, *w, k, DILS).float()
            got = k2.resblock_cmajor(x, *w, k, DILS).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            lim = TOL[dt] * max(1.0, ref.abs().max().item())
            if not err <= lim:
                raise AssertionError(f"K2 {dt} C={c} T={t} k={k}: err {err} > {lim}")
            row = {"dtype": str(dt), "C": c, "T": t, "k": k, "per_batch": 1,
                   "max_abs_err": err, "tol": lim}
            if dt == torch.float32:
                row["ms"] = cuda_ms(lambda: k2.resblock_cmajor(x, *w, k, DILS), 3)
                row["plain_ms"] = cuda_ms(
                    lambda: k2.resblock_cmajor_plain(x, *w, k, DILS), 2)
                n = WINDOW_BATCH * c * t
                nbytes = 2 * n * es + sum(p.numel() * p.element_size()
                                          for p in w)
                conv_ops = WINDOW_BATCH * t * 6 * 2 * c * c * k
                row["bound_ms"], row["bound_by"] = bound_ms(
                    nbytes, conv_ops + 6 * n * ACT_OPS)
            out["resblock_cmajor"].append(row)
        del x, ref, got
    return out


def summarize(rows, launches: int, name: str, source: str, replaces: str):
    f32 = [r for r in rows if r["dtype"] == "torch.float32"]
    per = lambda key: sum(r[key] * r["per_batch"] for r in f32)
    bounds = [(r["bound_ms"] * r["per_batch"], r["bound_by"]) for r in f32]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in f32),
            "ms": per("ms"), "plain_ms": per("plain_ms"),
            "bound_ms": sum(b for b, _ in bounds),
            "bound_by": max(bounds)[1], "library_ms": None,
            "per": f"one float32 window batch of {WINDOW_BATCH} at the "
                   "main-path shapes",
            "shapes": rows}


def run_request(tts: IndexTTS, prompt: str, text: str, n_rows: int) -> dict:
    before = (k1.snake_cmajor.launches, k2.resblock_cmajor.launches)
    t0 = time.perf_counter()
    sr, wav = tts.infer_fast(prompt, text, num_beams=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grew = (k1.snake_cmajor.launches - before[0],
            k2.resblock_cmajor.launches - before[1])
    res = tts.last_fused_res
    lens = res.lens.cpu().numpy()
    n_real = n_rows
    if res.codes.shape[0] != next(b for b in tts.FUSED_BATCH_BUCKETS if b >= n_real):
        raise AssertionError(f"batch {res.codes.shape[0]} is not the bucket of {n_real}")
    if lens[n_real:].any():
        raise AssertionError(f"dead rows produced frames: {lens}")
    want = int(lens[:n_real].sum()) * tts.vocoder.upsample
    if sr != 24000 or wav.dtype != np.int16 or wav.shape != (want, 1):
        raise AssertionError(f"wav {wav.dtype} {wav.shape}, want ({want}, 1) int16")
    if not np.isfinite(tts.last_wav).all():
        raise AssertionError("non-finite samples in the vocoder output")
    if wav.min() == wav.max():
        raise AssertionError("constant wav")
    if min(grew) < 1:
        raise AssertionError(f"kernel launches did not grow: {grew}")
    lt = tts.last_times
    return {"rows": n_real, "frames": lens[:n_real].tolist(),
            "audio_s": lt.audio_seconds, "wall_s": wall, "rtf": lt.rtf,
            "gpt_gen_s": lt.gpt_gen, "bigvgan_s": lt.bigvgan,
            "k1_launches": grew[0], "k2_launches": grew[1]}


def check_vocoder(tts: IndexTTS) -> float:
    """The windowed vocoder on the kernels (with its exact edge patches) vs
    the exact route over the whole stream in one piece, on a 300-frame
    stream of the last request's latents."""
    res = tts.last_fused_res
    frames = 300
    lat = res.lat[:1, :frames]
    spk = tts.vocoder.speaker_embedding(tts.cache_cond_mel.transpose(1, 2))
    got = tts.vocoder.stream_device(lat, np.array([frames]), spk=spk)
    ref = voc_mod._vocode_window_cmajor(
        tts.params["bigvgan"], tts.bigvgan_cfg,
        lat.to(tts.vocoder.compute_dtype), spk, use_kernels=False)[0]
    err = float(np.abs(got - ref.float().cpu().numpy()).max())
    if not err <= VOCODER_TOL:
        raise AssertionError(f"windowed vocoder vs exact: {err} > {VOCODER_TOL}")
    return err


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter
                            ).parse_args()
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one H100", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", t0, f"({kind}, torch {torch.__version__}, "
                        f"CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    cuda_lib.load()
    phase("build", t0, f"(nvcc {cuda_lib.last_build_seconds or 0.0:.2f} s, "
                       f"{cuda_lib.library_path().name})")

    t0 = time.perf_counter()
    checks = check_kernels(torch.Generator("cuda").manual_seed(0))
    worst = {n: {str(r["dtype"]): max(x["max_abs_err"] for x in rows
                                      if x["dtype"] == r["dtype"])
                 for r in rows} for n, rows in checks.items()}
    phase("kernels", t0, f"max_abs_err {json.dumps(worst)}")

    t0 = time.perf_counter()
    tts = IndexTTS(config=EngineConfig(), is_fp16=True, seed=0,
                   verbose_init=False)
    torch.cuda.synchronize()
    phase("init", t0, "(full-width EngineConfig, bf16, seed 0)")
    with tempfile.TemporaryDirectory() as tmp:
        prompt = str(Path(tmp) / "prompt.wav")
        rng = np.random.default_rng(0)
        tt = np.arange(3 * 24000) / 24000.0
        wav = (0.3 * np.sin(2 * np.pi * 180.0 * tt) * np.sin(2 * np.pi * 3.0 * tt)
               + 0.05 * rng.standard_normal(tt.size)).astype(np.float32)
        write_wav(prompt, wav, 24000)
        k1.snake_cmajor.launches = 0
        k2.resblock_cmajor.launches = 0
        reports = []
        for name, text, n_rows in (("warmup", TEXTS[0], 1),
                                   ("single", TEXTS[1], 1),
                                   ("multi", TEXTS[2], 3)):
            t1 = time.perf_counter()
            reports.append(run_request(tts, prompt, text, n_rows))
            phase(f"main/{name}", t1, json.dumps(reports[-1]))
        launches = (k1.snake_cmajor.launches, k2.resblock_cmajor.launches)
        t1 = time.perf_counter()
        verr = check_vocoder(tts)
        phase("main/vocoder-vs-exact", t1, f"max_abs_err {verr:.3g}")
    phase("main", t0)

    kernels = [
        summarize(checks["snake_cmajor"], launches[0], "snake_cmajor",
                  "index_tts_dubbing_tpu_torch/csrc/snake_cmajor.cu",
                  "index_tts_dubbing_tpu/ops/pallas_snake.py:168"),
        summarize(checks["resblock_cmajor"], launches[1], "resblock_cmajor",
                  "index_tts_dubbing_tpu_torch/csrc/resblock_cmajor.cu",
                  "index_tts_dubbing_tpu/ops/pallas_resblock.py:175"),
    ]
    print(json.dumps({"kernels": kernels}))
    phase("total", t_all)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
