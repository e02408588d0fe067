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
             main-path shapes, in float32 and bfloat16; holds copy_on_fork
             and the gen-cache gather (all four of its wrappers) equal to
             their plain versions at the full-width gen cache
             (20, 12, 16, 600, 64), in bfloat16 and float32, over several
             fork / source patterns and bounds; times each kernel beside its
             plain version, its bound and (for the permutes) a library gather.
4. main    - full-width EngineConfig(), bf16 random weights from seed 0, a
             3 s numpy prompt. Three paths, each with every launch count set
             to 0 just before it and read just after:
             sampling  - one IndexTTS.infer_fast(num_beams=1) request;
             beam      - three infer_fast requests with the reference's
                         defaults (num_beams=3, beam sampling, history
                         strategy "anc"): warm-up, one sentence, and three
                         sentences padded to a batch bucket with a dead row;
             beam-cof  - the beam decode with reorder="cof" on the last
                         request's prefix, which launches copy_on_fork once
                         per step, beside "anc" on the same prefix and noise.
             Checks each output's length, finiteness and launches; then holds
             the windowed vocoder on the kernels against the exact route.

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
from index_tts_dubbing_tpu_torch.engine import decode as decode_mod
from index_tts_dubbing_tpu_torch.engine import vocoder as voc_mod
from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS
from index_tts_dubbing_tpu_torch.ops import cuda_lib
from index_tts_dubbing_tpu_torch.ops import permute
from index_tts_dubbing_tpu_torch.ops import resblock_cmajor as k2
from index_tts_dubbing_tpu_torch.ops import snake_cmajor as k1
from index_tts_dubbing_tpu_torch.utils.audio import write_wav

WATCHDOG_S = 900
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
# the full-width gen cache of the beam decode: (L, B·nb, H, G, D) for a
# batch bucket of 4 rows × 3 beams and the 600-step decode cap
GEN_CACHE = (20, 12, 16, 600, 64)
PERMUTE_BOUNDS = (0, 59, 60, 299, 599)
# copy_on_fork row patterns over 4 groups of 3 beams (-1: the row keeps its
# history): no fork; one fork per group; the most forks (2 per group)
CP_PATTERNS = {
    "no_fork": [-1] * 12,
    "one_fork_per_group": [-1, -1, 0, -1, 3, -1, 7, -1, -1, -1, -1, 10],
    "max_forks": [-1, 0, 0, 5, -1, 5, -1, 6, 6, 11, 11, -1],
}
# headline cases of the kernels line: a mid-decode step (bound 299) with one
# fork per group, and the unbounded gather of a reversal
COF_HEADLINE = ("one_fork_per_group", 299)
GATHER_HEADLINE = ("reversal", None)
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


def _gather_sources() -> dict:
    """Gather patterns: a reversal, and each copy_on_fork pattern as a full
    permutation (identity rows where cp < 0)."""
    out = {"reversal": list(range(GEN_CACHE[1] - 1, -1, -1))}
    for name, cp in CP_PATTERNS.items():
        if name != "no_fork":
            out[name] = [c if c >= 0 else i for i, c in enumerate(cp)]
    return out


def check_permutes(gen: torch.Generator) -> dict:
    """copy_on_fork and the gather against their plain versions at the
    full-width gen cache, bit for bit (they only copy), in bfloat16 and
    float32; bfloat16 (the cache dtype under is_fp16) is timed."""
    dev = "cuda"
    l, bn, h, g_len, d = GEN_CACHE
    out = {"copy_on_fork": [], "gather": []}
    srcs = _gather_sources()
    for dt in (torch.bfloat16, torch.float32):
        es = torch.tensor([], dtype=dt).element_size()
        slab = l * h * g_len * d * es          # bytes of one row of one buffer
        kg = torch.randn(GEN_CACHE, generator=gen, device=dev).to(dt)
        vg = torch.randn(GEN_CACHE, generator=gen, device=dev).to(dt)
        for pattern, cp_list in CP_PATTERNS.items():
            cp = torch.tensor(cp_list, dtype=torch.int32, device=dev)
            forks = sum(c >= 0 for c in cp_list)
            sources = len({c for c in cp_list if c >= 0})
            ident = torch.where(cp >= 0, cp.long(),
                                torch.arange(bn, device=dev))
            for bound in PERMUTE_BOUNDS:
                k1_, v1_ = kg.clone(), vg.clone()
                k2_, v2_ = kg.clone(), vg.clone()
                permute.copy_on_fork(k1_, v1_, cp, bound)
                permute.copy_on_fork_plain(k2_, v2_, cp, bound)
                torch.cuda.synchronize()
                if not (torch.equal(k1_, k2_) and torch.equal(v1_, v2_)):
                    raise AssertionError(f"copy_on_fork {dt} {pattern} "
                                         f"bound={bound} differs from plain")
                n = permute.fork_slots(g_len, d, bound)
                row = {"dtype": str(dt), "pattern": pattern, "bound": bound,
                       "slots": n, "forks": forks, "max_abs_err": 0.0}
                if dt == torch.bfloat16:
                    # each source row read once, each forked row written
                    nbytes = 2 * (sources + forks) * slab * n / g_len + 4 * bn
                    row["bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
                    row["ms"] = cuda_ms(
                        lambda: permute.copy_on_fork(k1_, v1_, cp, bound), 20)
                    row["plain_ms"] = cuda_ms(
                        lambda: permute.copy_on_fork_plain(k2_, v2_, cp, bound),
                        20)
                    row["library_ms"] = cuda_ms(lambda: [
                        torch.index_select(a[:, :, :, :n], 1, ident)
                        for a in (k2_, v2_)], 20)
                out["copy_on_fork"].append(row)
                del k1_, v1_, k2_, v2_
        for pattern, src_list in srcs.items():
            src = torch.tensor(src_list, dtype=torch.int32, device=dev)
            for bound in (None,) + PERMUTE_BOUNDS:
                if bound is None:
                    fns = [(permute.permute_gen_cache, ()),
                           (permute.permute_gen_cache_pipelined, ())]
                    n = g_len
                else:
                    fns = [(permute.permute_gen_cache_burst, (bound,)),
                           (permute.permute_gen_cache_bounded, (bound,))]
                    n = permute.live_slots(g_len, bound, 64)
                ref = getattr(permute, fns[0][0].__name__ + "_plain")(
                    kg, vg, src, *fns[0][1])
                for fn, args in fns:
                    got = fn(kg, vg, src, *args)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                        raise AssertionError(f"{fn.__name__} {dt} {pattern} "
                                             f"bound={bound} differs from plain")
                row = {"dtype": str(dt), "pattern": pattern, "bound": bound,
                       "slots": n, "max_abs_err": 0.0}
                if dt == torch.bfloat16:
                    fn, args = fns[0]
                    # each distinct source row read once (its live slots),
                    # every output row written whole
                    nbytes = (2 * (len(set(src_list)) * slab * n / g_len
                                   + bn * slab) + 4 * bn)
                    row["bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
                    row["ms"] = cuda_ms(lambda: fn(kg, vg, src, *args), 20)
                    plain = getattr(permute, fn.__name__ + "_plain")
                    row["plain_ms"] = cuda_ms(lambda: plain(kg, vg, src, *args),
                                              20)
                    row["library_ms"] = cuda_ms(lambda: [
                        torch.index_select(a[:, :, :, :n], 1, src)
                        for a in (kg, vg)], 20)
                out["gather"].append(row)
                del got, ref
        del kg, vg
    return out


def summarize_permute(rows, headline, launches, name, source, replaces,
                      **extra):
    """The kernels-line entry of a permute kernel: the numbers of its
    headline case in bfloat16, every case under "cases"."""
    top = next(r for r in rows if r["dtype"] == "torch.bfloat16"
               and (r["pattern"], r["bound"]) == headline)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": top["library_ms"],
            "per": f"one call on the bfloat16 gen cache {GEN_CACHE}, "
                   f"pattern {headline[0]}, bound {headline[1]}; library: "
                   "torch.index_select per buffer over the same slots, which "
                   "moves every row",
            **extra, "cases": rows}


COUNTED = {"snake_cmajor": k1.snake_cmajor, "resblock_cmajor": k2.resblock_cmajor,
           "copy_on_fork": permute.copy_on_fork,
           **{fn.__name__: fn for fn in permute.GATHERS}}


def zero_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def run_request(tts: IndexTTS, prompt: str, text: str, n_rows: int,
                **kw) -> dict:
    before = read_counts()
    t0 = time.perf_counter()
    sr, wav = tts.infer_fast(prompt, text, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grew = {k: v - before[k] for k, v in read_counts().items()}
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
    if min(grew["snake_cmajor"], grew["resblock_cmajor"]) < 1:
        raise AssertionError(f"vocoder kernel launches did not grow: {grew}")
    lt = tts.last_times
    return {"rows": n_real, "decode": lt.decode, "steps": lt.decode_steps,
            "frames": lens[:n_real].tolist(),
            "audio_s": lt.audio_seconds, "wall_s": wall, "rtf": lt.rtf,
            "gpt_gen_s": lt.gpt_gen, "bigvgan_s": lt.bigvgan,
            "gpt_gen_ms_per_step": 1e3 * lt.gpt_gen / lt.decode_steps,
            "launches": {k: v for k, v in grew.items() if v}}


def check_beam_result(res, cfg, sc, live) -> None:
    """A beam result is well formed: lengths in [0, cap], codes valid mel
    codes, stop from each row's length on, dead rows empty."""
    lens = res.lengths.cpu()
    codes = res.codes.cpu()
    cap = sc.max_mel_tokens
    if codes.shape != (live.numel(), cap):
        raise AssertionError(f"codes {tuple(codes.shape)}")
    if not ((lens >= 0) & (lens <= cap)).all():
        raise AssertionError(f"lengths {lens.tolist()} outside [0, {cap}]")
    if not ((codes >= 0) & (codes < cfg.number_mel_codes)).all():
        raise AssertionError("codes outside the mel vocabulary")
    tail = torch.arange(cap)[None, :] >= lens[:, None]
    if not (codes[tail] == cfg.stop_mel_token).all():
        raise AssertionError("codes past a row's length are not stop")
    if lens[~live.cpu()].any():
        raise AssertionError(f"dead rows decoded: {lens.tolist()}")


def run_beam_strategies(tts: IndexTTS, prompt: str, text: str) -> dict:
    """The beam decode on ``text``'s padded batch (the last request's
    prefix) with reorder "anc" and "cof" in turns (anc, cof, cof, anc),
    every run from the same noise seed. Each runs with the launch counts set
    to 0 just before it; cof must launch copy_on_fork once per selection
    step, anc never."""
    params, cfg = tts.params["gpt"], tts.gpt_cfg
    sc = tts._sampling_config({})                 # the reference's defaults
    x = tts.fused_batch(tts.sentence_rows(text))
    conds = tts._conditioning(tts._cond_mel(prompt))
    emb, keep = decode_mod.build_prefix_emb(params, cfg, conds, x["ids"],
                                            x["pos"], x["seg"], x["cond_idx"])
    out = {"anc": [], "cof": []}
    codes = {}
    for reorder in ("anc", "cof", "cof", "anc"):
        gen = torch.Generator("cuda").manual_seed(1)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = decode_mod._beam_decode(params, cfg, sc, emb, keep, gen, 3, 0.0,
                                      stochastic=True, reorder=reorder,
                                      live=x["live"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        check_beam_result(res, cfg, sc, x["live"])
        forks = counts["copy_on_fork"]
        if forks != (res.steps if reorder == "cof" else 0):
            raise AssertionError(f"{reorder}: copy_on_fork launched {forks} "
                                 f"times over {res.steps} steps")
        codes.setdefault(reorder, []).append(res.codes.cpu())
        out[reorder].append({
            "bn": emb.shape[0] * 3, "steps": res.steps,
            "lengths": res.lengths.cpu().tolist(), "wall_s": wall,
            "ms_per_step": 1e3 * wall / res.steps,
            "launches": {k: v for k, v in counts.items() if v}})
    same = codes["anc"][0] == codes["cof"][0]
    out["agree"] = {
        "tokens": int(same.sum()), "of": same.numel(),
        "first_diff_step": [int(r.nonzero()[0]) if r.any() else None
                            for r in ~same],
        "anc_repeat_identical": bool(torch.equal(*codes["anc"])),
        "cof_repeat_identical": bool(torch.equal(*codes["cof"]))}
    return out


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
    phase("kernels/vocoder", t0, f"max_abs_err {json.dumps(worst)}")
    t1 = time.perf_counter()
    perms = check_permutes(torch.Generator("cuda").manual_seed(1))
    phase("kernels/permute", t1, "(copy_on_fork and the four gathers equal "
          f"their plain versions in {len(perms['copy_on_fork'])} + "
          f"{len(perms['gather'])} cases)")
    phase("kernels", t0)

    t0 = time.perf_counter()
    tts = IndexTTS(config=EngineConfig(), is_fp16=True, seed=0,
                   verbose_init=False)
    torch.cuda.synchronize()
    phase("init", t0, "(full-width EngineConfig, bf16, seed 0)")
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        prompt = str(Path(tmp) / "prompt.wav")
        rng = np.random.default_rng(0)
        tt = np.arange(3 * 24000) / 24000.0
        wav = (0.3 * np.sin(2 * np.pi * 180.0 * tt) * np.sin(2 * np.pi * 3.0 * tt)
               + 0.05 * rng.standard_normal(tt.size)).astype(np.float32)
        write_wav(prompt, wav, 24000)

        t1 = time.perf_counter()
        zero_counts()
        report = run_request(tts, prompt, TEXTS[1], 1, num_beams=1)
        paths["sampling"] = read_counts()
        phase("main/sampling", t1, json.dumps(report))

        zero_counts()
        for name, text, n_rows in (("warmup", TEXTS[0], 1),
                                   ("single", TEXTS[1], 1),
                                   ("multi", TEXTS[2], 3)):
            t1 = time.perf_counter()
            report = run_request(tts, prompt, text, n_rows)
            phase(f"main/beam/{name}", t1, json.dumps(report))
        paths["beam"] = read_counts()
        if paths["beam"]["copy_on_fork"]:
            raise AssertionError("the anc beam path launched copy_on_fork")

        t1 = time.perf_counter()
        strat = run_beam_strategies(tts, prompt, TEXTS[2])
        paths["beam-cof"] = strat["cof"][0]["launches"]
        phase("main/beam-cof", t1, json.dumps(strat))

        t1 = time.perf_counter()
        verr = check_vocoder(tts)
        phase("main/vocoder-vs-exact", t1, f"max_abs_err {verr:.3g}")
    phase("main", t0)

    by_path = lambda name: {p: c.get(name, 0) for p, c in paths.items()}
    gathers = {p: sum(c.get(fn.__name__, 0) for fn in permute.GATHERS)
               for p, c in paths.items()}
    pallas_permute = "index_tts_dubbing_tpu/ops/pallas_permute.py"
    kernels = [
        summarize(checks["snake_cmajor"], paths["beam"]["snake_cmajor"],
                  "snake_cmajor",
                  "index_tts_dubbing_tpu_torch/csrc/snake_cmajor.cu",
                  "index_tts_dubbing_tpu/ops/pallas_snake.py:168"),
        summarize(checks["resblock_cmajor"], paths["beam"]["resblock_cmajor"],
                  "resblock_cmajor",
                  "index_tts_dubbing_tpu_torch/csrc/resblock_cmajor.cu",
                  "index_tts_dubbing_tpu/ops/pallas_resblock.py:175"),
        summarize_permute(perms["copy_on_fork"], COF_HEADLINE,
                          paths["beam-cof"]["copy_on_fork"], "copy_on_fork",
                          "index_tts_dubbing_tpu_torch/csrc/permute.cu",
                          f"{pallas_permute}:182"),
        summarize_permute(perms["gather"], GATHER_HEADLINE,
                          sum(gathers.values()), "permute_gen_cache",
                          "index_tts_dubbing_tpu_torch/csrc/permute.cu",
                          f"{pallas_permute}:41",
                          also_replaces=[f"{pallas_permute}:{n}"
                                         for n in (87, 266, 306)],
                          launches_note="no caller on any path: only the "
                                        "kernel phase launches it"),
    ]
    for k, name in zip(kernels, ("snake_cmajor", "resblock_cmajor",
                                 "copy_on_fork")):
        k["launches_by_path"] = by_path(name)
    kernels[0]["launches_note"] = kernels[1]["launches_note"] = (
        "launches: the default beam path (three requests)")
    kernels[2]["launches_note"] = "launches: the beam-cof decode"
    kernels[3]["launches_by_path"] = gathers
    print(json.dumps({"kernels": kernels}))
    phase("total", t_all)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
