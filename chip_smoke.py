#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (index_tts_dubbing_tpu_torch) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed with its wall seconds; any failure exits non-zero:

1. device  - a CUDA device must exist; prints nvidia-smi's name and power limit.
2. build   - compiles the kernels (csrc/*.cu, one nvcc call) into
             index_tts_dubbing_tpu_torch/_build/.
3. kernels - holds K1 (snake_cmajor), K2 (resblock_cmajor) and B3
             (snake_clast, channels-last) against their plain PyTorch
             versions over whole tensors at the vocoder's shapes (C-major
             route for K1/K2, reference-structured route for B3), in float32
             and bfloat16; holds copy_on_fork
             and the gen-cache gather (all four of its wrappers) equal to
             their plain versions at the full-width gen cache
             (20, 12, 16, 600, 64), in bfloat16 and float32, over several
             fork / source patterns and bounds; times each kernel beside its
             plain version, its bound and (for the permutes) a library gather;
             K2 also beside the six convs of its plain version (convs_ms)
             and the bound of its three-pass TF32 arithmetic (bound_tc_ms).
             k2-widths: K2 against its plain version at C in K2_WIDTHS (2 …
             128, each run on its padded width) × k in (3, 7, 11), float32
             and bfloat16, 2 windows of 4700 samples, timed in float32
             beside its plain version; C = 129 must raise.
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
                         per step, beside "anc" on the same prefix and noise;
                         then both once more in float32 (the weights cast to
                         float32, the same seed) for 64 steps, the count of
                         equal tokens printed, not asserted.
             Checks each output's length, finiteness and launches; then holds
             the windowed vocoder on the kernels against the exact route.
             vocoder-ref - WindowedVocoder(layout="ref") with use_pallas on
                         the engine's bf16 weights vocodes the multi
                         request's first row (600 frames, 6 windows in
                         batches of 4 + 2) through stream_device, which must
                         launch B3 109 times per window batch and K1/K2
                         never; __call__ on the host copy must agree, and the
                         exact route (use_pallas off) within VOCODER_TOL at
                         least 16 frames from the ends and within EDGE_TOL
                         everywhere; models/bigvgan.forward runs once on 144
                         frames; IndexTTS(use_pallas=True) is built on the
                         same weights.
             Then the rest of the engine, each path with the reference's
             default decode and its output checked (int16 at 24 kHz, finite,
             not constant, the length of its sentences' frames) and K1 and K2
             launched on it:
             fused       - infer_fast, three sentences at max_mel_tokens=256:
                         the one-program flavour (3 rows + 1 dead, a static
                         plan of 8 windows, int16 made on the device, exactly
                         clip(wav·32767) truncated), its float32 wav within
                         VOCODER_TOL of stream_device on the same latents;
             fused-short - infer_fast, one sentence at max_mel_tokens=100: a
                         stream under window + 2·halo frames, re-vocoded at
                         its exact length after the static plan ran;
             staged      - infer_fast on one 121-150-token sentence, past the
                         largest text bucket: the staged route;
             infer       - infer on three sentences, one decode each;
             infer_batch - two texts on the fused route, then three with an
                         empty one in the middle on the staged route (with at
                         most 8 sentences the empty one decodes as the
                         one-token row [2], as in the JAX engine).
5. surface - the user surfaces on the same bf16 weights, each call with
             every launch count set to 0 just before it and K1 and K2
             required after it. Every engine a surface builds is a
             CountedTTS: it counts its infer / infer_batch calls and keeps
             their errors and reports, because the dubbing strategies catch
             an engine's exceptions (a failed batch falls back to per-entry
             calls, a failed entry to silence).
             checkpoint  - the running engine's weights written as float32
                         gpt.npz + bigvgan.npz (utils.checkpoint), then
                         IndexTTS(model_dir=..., is_fp16=True): every leaf
                         equal; bytes, write and load seconds;
             cli         - cli.main with --model_dir --fp16 --fast -f on one
                         sentence (the CLI's 600-step cap, infer_fast): an
                         int16 24 kHz wav of whole frames, not constant;
             dubbing-stretch - dubbing.cli.main with the stretch strategy on
                         three SRT entries (one Chinese) and the CLI's
                         defaults: exactly one infer_batch, no silent
                         segment, the merged wav sounding in every placed
                         segment and every entry's span;
             dubbing-adaptive - the CLI's five stages driven here with the
                         adaptive strategy on two entries and
                         max_mel_tokens=150: per entry one infer and one
                         infer_batch of 4 candidates whose codes differ
                         pairwise, no silent segment.
             Random weights never emit the stop token, so every candidate has
             the same length: which one wins is not checked.
6. slice 8 - each path with every launch count set to 0 just before it and
             K1 and K2 required after it (trace runs last, after the
             surfaces):
             small/infer_fast - tests/test_engine.py's small_config() on the
                         card in float32: K2 at every stage width (64 … 2),
                         the one-program wav within VOCODER_TOL of the exact
                         route over the same latents;
             int8        - IndexTTS(quantize="int8") on the bf16 weights
                         beside the bf16 engine, one infer_fast each at cap
                         200 in turns (bf16, int8, int8, bf16): ms a step,
                         bytes, equal tokens (printed, not asserted);
             continuous  - infer_batch(continuous=True, cb_slots=8) on 12
                         sentences of 4 texts at cap 200 beside
                         infer_batch(num_beams=1); the ContinuousBatcher with
                         caps from 40 to 200 (refills, occupancy); float32
                         greedy rows against decode.generate (equal, or a
                         near-tie under GAP_TOL);
             legacy-cond - a full-width v1.0 tree: float32 get_conditioning
                         on the card within 1e-3 relative of the CPU's, one
                         bf16 infer_fast at cap 100;
             trace       - one request's gpt_gen split by stage; then 32
                         decode steps of the BN 12 and the BN 3 beam request,
                         plain and under utils.profiling.trace: device busy
                         time, idle share, ms a step, top-10 device ops.
Then one JSON line describing the kernels and, last, the device line.
Float32 convs and products run without TF32 throughout (set below), so the
plain versions are float32 references.
"""
import argparse
import contextlib
import faulthandler
import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time
import wave
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch import cli as cli_mod
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.config import EngineConfig
from index_tts_dubbing_tpu_torch.dubbing import cli as dub_cli
from index_tts_dubbing_tpu_torch.dubbing import config as dub_config
from index_tts_dubbing_tpu_torch.dubbing import engines as dub_engines
from index_tts_dubbing_tpu_torch.dubbing import strategies as dub_strategies
from index_tts_dubbing_tpu_torch.dubbing.audio_processor import AudioProcessor
from index_tts_dubbing_tpu_torch.dubbing.srt_parser import SRTParser
from index_tts_dubbing_tpu_torch.engine import continuous as cb
from index_tts_dubbing_tpu_torch.engine import decode as decode_mod
from index_tts_dubbing_tpu_torch.engine import tts as tts_mod
from index_tts_dubbing_tpu_torch.engine import vocoder as voc_mod
from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS
from index_tts_dubbing_tpu_torch.models import bigvgan as bigvgan_mod
from index_tts_dubbing_tpu_torch.models import gpt as gpt_model
from index_tts_dubbing_tpu_torch.models import legacy_cond
from index_tts_dubbing_tpu_torch.ops import cuda_lib
from index_tts_dubbing_tpu_torch.ops import permute
from index_tts_dubbing_tpu_torch.ops import resblock_cmajor as k2
from index_tts_dubbing_tpu_torch.ops import snake_clast as b3
from index_tts_dubbing_tpu_torch.ops import snake_cmajor as k1
from index_tts_dubbing_tpu_torch.utils import checkpoint, profiling
from index_tts_dubbing_tpu_torch.utils.audio import write_wav

WATCHDOG_S = 900
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # dense bf16 tensor cores
TF32_OPS_PER_S = 495e12          # dense TF32 tensor cores
WINDOW_BATCH = 4                 # windows per vocoder call in the checks
# K1 per window batch: 18 activations in each C > 128 stage, plus act_post
K1_SHAPES = [(768, 576, 18), (384, 2304, 18), (192, 9216, 18), (24, 147456, 1)]
# K2 per window batch: one resblock per kernel size in each C <= 128 stage
K2_SHAPES = [(c, t, k) for c, t in ((96, 36864), (48, 73728), (24, 147456))
             for k in (3, 7, 11)]
DILS = (1, 3, 5)
# B3 per window batch of the reference-structured route: every activation
# of every stage (18 = 3 resblocks x 6), plus act_post at C = 24: 109
B3_SHAPES = [(768, 576, 18), (384, 2304, 18), (192, 9216, 18),
             (96, 36864, 18), (48, 73728, 18), (24, 147456, 19)]
B3_PER_BATCH = sum(n for _, _, n in B3_SHAPES)
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
# B3 (as its Pallas original) recomputes its up-phases over the replicated
# input within ±3 frames of a true boundary, where the exact route
# zero-pads: tests/test_pallas_snake.py holds the Pallas kernel's edges to
# 0.2 of the exact route, and the ref route applies no edge patches, so the
# whole stream is held to the same bound (the interior to VOCODER_TOL)
EDGE_TOL = 0.2
EDGE_FRAMES = 16
# int16 LSBs between two routes over the same float32 latents
I16_TOL = 2
TEXTS = [
    "The quick brown fox jumps over the lazy dog near the river bank.",
    "Hello there, this is the first slice of the port speaking on the card.",
    "Zero shot speech synthesis turns a short prompt into a voice that reads "
    "any text aloud. The decoder samples mel codes one token at a time from "
    "the language model. The vocoder then turns those codes into a waveform "
    "at twenty four kilohertz.",
]
# one sentence of 121-150 tokens with no stop inside: past the largest text
# bucket (120), so _fused_eligible refuses it
LONG_SENTENCE = ("a dubbing editor waits on every line of a film so the engine "
                 "reads this long sentence without a single stop inside it and "
                 "the text bucket gives way at last")


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


def bound_ms(nbytes: float, fp32_ops: float, bf16_ops: float = 0.0,
             tf32_ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (fp32_ops / FP32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S
             + tf32_ops / TF32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


ACT_OPS = 58    # float32 ops per activation output: 2×6-tap up, 2 snakes, 12-tap down


def k2_convs(c: int, t: int, k: int):
    """The six valid-mode convs of K2's plain version at one shape: (input,
    weight, dilation) at the widths the chain gives them, from their own
    seed (the checks' inputs stay as they were)."""
    gen = torch.Generator("cuda").manual_seed(2)
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    width = t + 2 * k2.chain_shrink(k, DILS)
    convs = []
    for d in DILS:
        n = width - 12
        convs.append((rand(WINDOW_BATCH, c, n), rand(c, c, k) * 0.1, d))
        n -= d * (k - 1) + 12
        convs.append((rand(WINDOW_BATCH, c, n), rand(c, c, k) * 0.1, 1))
        width -= 24 + (d + 1) * (k - 1)
    return convs


def rand_resblock(rand, c: int, k: int) -> dict:
    """A resblock's random weights at the checks' scale (weights and biases
    N(0, 1)·0.1, α and β N(0, 1)·0.3), drawn by ``rand``."""
    conv = lambda: {"w": rand(k, c, c) * 0.1, "b": rand(c) * 0.1}
    return {"convs1": [conv() for _ in range(3)],
            "convs2": [conv() for _ in range(3)],
            "acts": [{"alpha": rand(c) * 0.3, "beta": rand(c) * 0.3}
                     for _ in range(6)]}


def check_kernels(gen: torch.Generator):
    """Each kernel vs its plain version at the main-path shapes; returns
    per-kernel timings (float32, one window batch) and errors."""
    dev = "cuda"
    rand = lambda *s: torch.randn(*s, generator=gen, device=dev)
    out = {"snake_cmajor": [], "resblock_cmajor": [], "snake_clast": []}
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
                   "max_abs_err": err, "tol": lim, "run": k1.RUN}
            if dt == torch.float32:
                row["ms"] = cuda_ms(lambda: k1.snake_cmajor(x, al, be, True), 10)
                row["plain_ms"] = cuda_ms(
                    lambda: k1.snake_cmajor_plain(x, al, be, True), 3)
                n = WINDOW_BATCH * c * t
                row["bound_ms"], row["bound_by"] = bound_ms(
                    2 * n * es + 8 * c, n * ACT_OPS)
            out["snake_cmajor"].append(row)
        for c, t, per_batch in B3_SHAPES:
            x = rand(WINDOW_BATCH, t, c).to(dt)
            al, be = rand(c) * 0.3, rand(c) * 0.3
            ref = b3.snake_clast_plain(x, al, be, True).float()
            got = b3.snake_clast(x, al, be, True).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            lim = TOL[dt] * max(1.0, ref.abs().max().item())
            if not err <= lim:
                raise AssertionError(f"B3 {dt} C={c} T={t}: err {err} > {lim}")
            vec, run, _, threads = b3.launch_plan(x)
            row = {"dtype": str(dt), "C": c, "T": t, "per_batch": per_batch,
                   "max_abs_err": err, "tol": lim, "vec": vec, "run": run,
                   "threads": threads}
            if dt == torch.float32:
                row["ms"] = cuda_ms(lambda: b3.snake_clast(x, al, be, True), 10)
                row["plain_ms"] = cuda_ms(
                    lambda: b3.snake_clast_plain(x, al, be, True), 3)
                n = WINDOW_BATCH * c * t
                row["bound_ms"], row["bound_by"] = bound_ms(
                    2 * n * es + 8 * c, n * ACT_OPS)
            out["snake_clast"].append(row)
        for c, t, k in K2_SHAPES:
            w = k2.pack_resblock(rand_resblock(rand, c, k),
                                 EngineConfig().bigvgan, dt)
            x = (rand(WINDOW_BATCH, c, t) * 0.5).to(dt)
            ref = k2.resblock_cmajor_plain(x, *w, k, DILS).float()
            got = k2.resblock_cmajor(x, *w, k, DILS).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            lim = TOL[dt] * max(1.0, ref.abs().max().item())
            if not err <= lim:
                raise AssertionError(f"K2 {dt} C={c} T={t} k={k}: err {err} > {lim}")
            tt = k2.pick_tile(c, k, DILS, t)
            row = {"dtype": str(dt), "C": c, "T": t, "k": k, "per_batch": 1,
                   "max_abs_err": err, "tol": lim, "tt": tt,
                   "w_over_tt": (tt + 2 * k2.chain_shrink(k, DILS)) / tt}
            if dt == torch.float32:
                row["ms"] = cuda_ms(lambda: k2.resblock_cmajor(x, *w, k, DILS), 3)
                row["plain_ms"] = cuda_ms(
                    lambda: k2.resblock_cmajor_plain(x, *w, k, DILS), 2)
                # diagnostic: the plain version's six convs alone (cuDNN,
                # float32 without TF32); not a library call for K2
                convs = k2_convs(c, t, k)
                row["convs_ms"] = cuda_ms(lambda: [
                    F.conv1d(v, wt, dilation=d) for v, wt, d in convs], 2)
                del convs
                n = WINDOW_BATCH * c * t
                nbytes = 2 * n * es + sum(p.numel() * p.element_size()
                                          for p in w)
                conv_ops = WINDOW_BATCH * t * 6 * 2 * c * c * k
                row["bound_ms"], row["bound_by"] = bound_ms(
                    nbytes, conv_ops + 6 * n * ACT_OPS)
                # the arithmetic K2 runs: three TF32 passes per product
                row["bound_tc_ms"], row["bound_tc_by"] = bound_ms(
                    nbytes, 6 * n * ACT_OPS, tf32_ops=3 * conv_ops)
            out["resblock_cmajor"].append(row)
        del x, ref, got
    return out


# K2 at every width class it is built for and between them (C is padded to
# the next of k2.KERNEL_WIDTHS), at two windows of a ragged length
K2_WIDTHS = (2, 4, 8, 16, 24, 32, 40, 48, 64, 72, 96, 128)
K2_WIDTH_T = 4700


def check_k2_widths(gen: torch.Generator) -> list:
    """K2 against its plain version at every C of K2_WIDTHS × k in (3, 7,
    11), float32 and bfloat16, within TOL; float32 timed beside the plain
    version and its bound. C = 129 must raise."""
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dt).element_size()
        for c in K2_WIDTHS:
            for k in (3, 7, 11):
                w = k2.pack_resblock(rand_resblock(rand, c, k),
                                     EngineConfig().bigvgan, dt)
                x = (rand(2, c, K2_WIDTH_T) * 0.5).to(dt)
                ref = k2.resblock_cmajor_plain(x, *w, k, DILS).float()
                got = k2.resblock_cmajor(x, *w, k, DILS).float()
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                lim = TOL[dt] * max(1.0, ref.abs().max().item())
                if not err <= lim:
                    raise AssertionError(f"K2 {dt} C={c} k={k}: err {err} > {lim}")
                row = {"dtype": str(dt), "C": c, "Cp": k2.kernel_width(c),
                       "T": K2_WIDTH_T, "k": k, "B": 2, "max_abs_err": err,
                       "tol": lim, "tt": k2.pick_tile(c, k, DILS, K2_WIDTH_T)}
                if dt == torch.float32:
                    row["ms"] = cuda_ms(lambda: k2.resblock_cmajor(x, *w, k, DILS), 5)
                    row["plain_ms"] = cuda_ms(
                        lambda: k2.resblock_cmajor_plain(x, *w, k, DILS), 3)
                    n = 2 * c * K2_WIDTH_T
                    nbytes = 2 * n * es + sum(p.numel() * p.element_size()
                                              for p in w)
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        nbytes, 2 * K2_WIDTH_T * 6 * 2 * c * c * k
                        + 6 * n * ACT_OPS)
                rows.append(row)
    x = torch.zeros(1, 129, 64, device="cuda")
    try:
        k2.resblock_cmajor(x, x, x, x, x, x, 3, DILS)
    except ValueError:
        pass
    else:
        raise AssertionError("K2 took C = 129")
    return rows


# untimed cases off the main path's shapes, each within TOL of the plain
# version in both dtypes: T % 8 != 0, T < K1's run, C % 4 != 0, one time
# step, and inputs 4 bytes off a 16-byte boundary (offset 1), which take the
# kernels' scalar load paths
K1_RAGGED = [(2, 768, 577, 0), (1, 24, 5, 0), (3, 96, 1, 0), (1, 24, 64, 1)]
B3_RAGGED = [(1, 1000, 6, 0), (2, 577, 768, 0), (1, 1, 24, 0), (1, 64, 24, 1)]
# the kernels fold SnakeBeta's raw parameters themselves: (parameter dtype,
# beta given, log-scale) beyond the float32 / beta / log-scale of the rest,
# each at (B, C, T) = (2, 96, 577) for K1 and its transpose for B3
PARAM_CASES = [(torch.bfloat16, True, True), (torch.float32, False, True),
               (torch.bfloat16, True, False)]


def check_ragged(gen: torch.Generator) -> dict:
    """K1 and B3 against their plain versions at the ragged cases."""
    out = {"snake_cmajor": [], "snake_clast": []}
    cases = [("snake_cmajor", k1.snake_cmajor, k1.snake_cmajor_plain, K1_RAGGED),
             ("snake_clast", b3.snake_clast, b3.snake_clast_plain, B3_RAGGED)]
    for dt in (torch.float32, torch.bfloat16):
        for name, fn, plain, shapes in cases:
            for b, d1, d2, offset in shapes:
                n = b * d1 * d2
                flat = torch.randn(n + offset, generator=gen, device="cuda")
                x = flat.to(dt)[offset:].view(b, d1, d2)
                c = d1 if name == "snake_cmajor" else d2
                al = torch.randn(c, generator=gen, device="cuda") * 0.3
                be = torch.randn(c, generator=gen, device="cuda") * 0.3
                ref = plain(x, al, be, True).float()
                got = fn(x, al, be, True).float()
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                lim = TOL[dt] * max(1.0, ref.abs().max().item())
                if not err <= lim:
                    raise AssertionError(f"{name} {dt} {(b, d1, d2)} offset "
                                         f"{offset}: err {err} > {lim}")
                out[name].append({"dtype": str(dt), "shape": [b, d1, d2],
                                  "offset": offset, "max_abs_err": err,
                                  "tol": lim})
        for name, fn, plain, _ in cases:
            shape = (2, 96, 577) if name == "snake_cmajor" else (2, 577, 96)
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            for pdt, with_beta, logscale in PARAM_CASES:
                al = torch.randn(96, generator=gen, device="cuda") * 0.3
                be = torch.randn(96, generator=gen, device="cuda") * 0.3
                if not logscale:          # α, β as trained without log-scale
                    al, be = al.exp(), be.exp()
                al, be = al.to(pdt), (be.to(pdt) if with_beta else None)
                ref = plain(x, al, be, logscale).float()
                got = fn(x, al, be, logscale).float()
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                lim = TOL[dt] * max(1.0, ref.abs().max().item())
                case = [str(pdt), with_beta, logscale]
                if not err <= lim:
                    raise AssertionError(f"{name} {dt} params {case}: err "
                                         f"{err} > {lim}")
                out[name].append({"dtype": str(dt), "shape": list(shape),
                                  "params": case, "max_abs_err": err,
                                  "tol": lim})
    return out


def summarize(rows, launches: int, name: str, source: str, replaces: str):
    f32 = [r for r in rows if r["dtype"] == "torch.float32"]
    per = lambda key: sum(r[key] * r["per_batch"] for r in f32)
    bounds = [(r["bound_ms"] * r["per_batch"], r["bound_by"]) for r in f32]
    extra = {key: per(key) for key in ("bound_tc_ms", "convs_ms")
             if key in f32[0]}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in f32),
            "ms": per("ms"), "plain_ms": per("plain_ms"),
            "bound_ms": sum(b for b, _ in bounds),
            "bound_by": max(bounds)[1], "library_ms": None, **extra,
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
           "snake_clast": b3.snake_clast,
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
    out["agree"] = dict(agreement(codes["anc"][0], codes["cof"][0]),
                        anc_repeat_identical=bool(torch.equal(*codes["anc"])),
                        cof_repeat_identical=bool(torch.equal(*codes["cof"])))
    # ROADMAP C6: the same prefix and seed in float32 (the bf16 weights cast
    # up, float32 products without TF32), 64 steps; reported, not asserted
    p32 = weights.cast_floating(params, torch.float32)
    emb32, keep32 = decode_mod.build_prefix_emb(p32, cfg, conds, x["ids"],
                                                x["pos"], x["seg"],
                                                x["cond_idx"])
    sc64 = replace(sc, max_mel_tokens=64)
    f32 = {}
    for reorder in ("anc", "cof"):
        gen = torch.Generator("cuda").manual_seed(1)
        f32[reorder] = decode_mod._beam_decode(
            p32, cfg, sc64, emb32, keep32, gen, 3, 0.0, stochastic=True,
            reorder=reorder, live=x["live"]).codes.cpu()
    out["agree_float32"] = dict(agreement(f32["anc"], f32["cof"]), steps=64)
    del p32, emb32
    return out


def agreement(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Equal tokens of two (rows, steps) code tensors, and per row the first
    step at which they differ (None: never)."""
    same = a == b
    return {"tokens": int(same.sum()), "of": same.numel(),
            "first_diff_step": [int(r.nonzero()[0]) if r.any() else None
                                for r in ~same]}


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


def run_vocoder_ref(tts: IndexTTS) -> dict:
    """The reference-structured windowed vocoder with B3 on the multi
    request's first row, through stream_device (counted from zero) and
    __call__; the exact route beside it; bigvgan.forward on 144 frames; an
    engine with use_pallas on the same weights."""
    res = tts.last_fused_res
    frames = int(res.lens[0])
    lat = res.lat[:1, :frames]
    spk = tts.vocoder.speaker_embedding(tts.cache_cond_mel.transpose(1, 2))
    bcfg = replace(tts.bigvgan_cfg, use_pallas=True)
    voc = voc_mod.WindowedVocoder(tts.params["bigvgan"], bcfg, layout="ref",
                                  compute_dtype=tts.dtype)
    batches = len(list(voc._plan_batches(voc._window_list(frames))))
    up = voc.upsample
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    wav = voc.stream_device(lat, np.array([frames]), spk=spk)
    stream_s = time.perf_counter() - t0
    counts = read_counts()
    want = {name: 0 for name in COUNTED}
    want["snake_clast"] = B3_PER_BATCH * batches
    if counts != want:
        raise AssertionError(f"vocoder-ref launches {counts}, want {want}")
    if wav.shape != (frames * up,) or not np.isfinite(wav).all():
        raise AssertionError(f"vocoder-ref wav {wav.shape}, finite "
                             f"{np.isfinite(wav).all()}")
    host = voc(lat[0].float().cpu().numpy(), spk=spk)
    host_err = float(np.abs(host - wav).max())
    if not host_err <= 1e-6:
        raise AssertionError(f"__call__ vs stream_device: {host_err}")
    exact = voc_mod.WindowedVocoder(
        tts.params["bigvgan"], tts.bigvgan_cfg, layout="ref",
        compute_dtype=tts.dtype).stream_device(lat, np.array([frames]),
                                               spk=spk)
    diff = np.abs(wav - exact)
    inner = float(diff[EDGE_FRAMES * up: (frames - EDGE_FRAMES) * up].max())
    whole = float(diff.max())
    if not (inner <= VOCODER_TOL and whole <= EDGE_TOL):
        raise AssertionError(f"vocoder-ref vs exact: interior {inner} > "
                             f"{VOCODER_TOL} or whole {whole} > {EDGE_TOL}")
    n_fwd = 144
    before = b3.snake_clast.launches
    fwd = bigvgan_mod.forward(tts.params["bigvgan"], bcfg,
                              lat[:, :n_fwd].to(tts.dtype),
                              tts.cache_cond_mel.transpose(1, 2))
    win = voc_mod._vocode_window(tts.params["bigvgan"], bcfg,
                                 lat[:, :n_fwd].to(tts.dtype), spk)
    fwd_err = (fwd.float() - win.float()).abs().max().item()
    if fwd.shape != (1, n_fwd * up) or not torch.isfinite(fwd).all() \
            or not fwd_err <= 1e-6:
        raise AssertionError(f"bigvgan.forward {tuple(fwd.shape)}, vs the "
                             f"window function {fwd_err}")
    if b3.snake_clast.launches - before != 2 * B3_PER_BATCH:
        raise AssertionError("bigvgan.forward did not run on B3")
    flagged = IndexTTS(config=tts.cfg, device=tts.device, is_fp16=True,
                       params=tts.params, use_pallas=True, verbose_init=False)
    if not (flagged.bigvgan_cfg.use_pallas and flagged.vocoder.layout == "cmajor"):
        raise AssertionError("IndexTTS(use_pallas=True) configuration")
    return {"frames": frames, "windows": len(voc._window_list(frames)),
            "window_batches": batches, "stream_s": stream_s,
            "launches": {k: v for k, v in counts.items() if v},
            "host_vs_stream": host_err, "vs_exact_interior": inner,
            "vs_exact_whole": whole, "forward_vs_window": fwd_err}


def run_path(tts: IndexTTS, call):
    """One request of the engine with every launch count set to 0 just
    before it: (its output, the counts, a report). K1 and K2 must launch."""
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if min(counts["snake_cmajor"], counts["resblock_cmajor"]) < 1:
        raise AssertionError(f"vocoder kernels did not launch: {counts}")
    lt = tts.last_times
    frames = np.asarray(tts.last_sentence_frames)
    report = {"path": tts.last_path, "decode": lt.decode,
              "steps": lt.decode_steps, "frames": frames.tolist(),
              "audio_s": lt.audio_seconds, "wall_s": wall, "rtf": lt.rtf,
              "gpt_gen_s": lt.gpt_gen, "gpt_forward_s": lt.gpt_forward,
              "bigvgan_s": lt.bigvgan,
              "gpt_gen_ms_per_step": 1e3 * lt.gpt_gen / max(lt.decode_steps, 1),
              "launches": {k: v for k, v in counts.items() if v}}
    return out, counts, report


def check_audio(name: str, sr: int, wav: np.ndarray, frames: int,
                upsample: int) -> None:
    """int16 at 24 kHz, (frames·upsample, 1), not constant."""
    want = int(frames) * upsample
    if sr != 24000 or wav.dtype != np.int16 or wav.shape != (want, 1):
        raise AssertionError(f"{name}: {sr} Hz {wav.dtype} {wav.shape}, want "
                             f"24000 Hz int16 ({want}, 1)")
    if want and wav.min() == wav.max():
        raise AssertionError(f"{name}: constant wav")


def check_finite(name: str, wav: np.ndarray) -> None:
    if not np.isfinite(wav).all():
        raise AssertionError(f"{name}: non-finite samples")


def to_i16(wav: np.ndarray) -> np.ndarray:
    return np.clip(wav * 32767.0, -32767.0, 32767.0).astype(np.int16)


def expect(name: str, tts: IndexTTS, path: str, flavor=None) -> None:
    got = (tts.last_path, tts.last_fused_flavor if flavor else None)
    if got != (path, flavor):
        raise AssertionError(f"{name}: took {got}, want {(path, flavor)}")


def run_fused(tts: IndexTTS, prompt: str, spk: torch.Tensor):
    """Three sentences at max_mel_tokens=256: the one-program flavour."""
    voc = tts.vocoder
    (sr, wav), counts, rep = run_path(
        tts, lambda: tts.infer_fast(prompt, TEXTS[2], max_mel_tokens=256))
    expect("fused", tts, "fused", "fused")
    res = tts.last_fused_res
    lens = res.lens.cpu().numpy()
    if res.codes.shape[0] != 4 or lens[3] != 0:
        raise AssertionError(f"fused: batch {res.codes.shape[0]}, lens {lens}")
    windows = res.wav.numel() // (voc.window * voc.upsample)
    if windows != 8:
        raise AssertionError(f"fused: {windows} windows planned, want 8")
    t = int(res.stream_frames)
    check_audio("fused", sr, wav, lens.sum(), voc.upsample)
    fwav = res.wav.cpu().numpy()
    check_finite("fused", fwav[: t * voc.upsample])
    if not np.array_equal(res.wav_i16.cpu().numpy(), to_i16(fwav)):
        raise AssertionError("fused: wav_i16 is not clip(wav·32767) truncated")
    if not np.array_equal(wav[:, 0], to_i16(fwav[: t * voc.upsample])):
        raise AssertionError("fused: the output is not the device's int16")
    ref = voc.stream_device(res.lat, lens, order=np.arange(3), spk=spk)
    err = float(np.abs(fwav[: t * voc.upsample] - ref).max())
    if not err <= VOCODER_TOL:
        raise AssertionError(f"fused vs stream_device: {err} > {VOCODER_TOL}")
    rep.update(rows=3, windows=windows, stream_frames=t,
               vs_stream_device=err)
    return counts, rep


def run_fused_short(tts: IndexTTS, prompt: str, spk: torch.Tensor):
    """One sentence at max_mel_tokens=100: shorter than window + 2·halo, so
    re-vocoded at its exact length; held to the exact stream within
    I16_TOL."""
    voc = tts.vocoder
    (sr, wav), counts, rep = run_path(
        tts, lambda: tts.infer_fast(prompt, TEXTS[0], max_mel_tokens=100))
    expect("fused-short", tts, "fused", "fused")
    res = tts.last_fused_res
    lens = res.lens.cpu().numpy()
    t = int(res.stream_frames)
    if not t < voc.window + 2 * voc.halo:
        raise AssertionError(f"fused-short: {t} frames, no short fallback")
    check_audio("fused-short", sr, wav, lens.sum(), voc.upsample)
    ref = voc.stream_device(res.lat, lens, order=np.arange(1), spk=spk)
    check_finite("fused-short", ref)
    diff = int(np.abs(to_i16(ref).astype(np.int32)
                      - wav[:, 0].astype(np.int32)).max())
    if diff > I16_TOL:
        raise AssertionError(f"fused-short vs the exact stream: {diff} LSB")
    rep.update(rows=1, stream_frames=t, vs_exact_stream_lsb=diff)
    return counts, rep


def run_staged(tts: IndexTTS, prompt: str):
    """infer_fast on one sentence past the largest text bucket."""
    rows = tts.sentence_rows(LONG_SENTENCE, 200)
    if len(rows) != 1 or not 121 <= rows[0].size <= 150 \
            or tts._fused_eligible(rows):
        raise AssertionError(f"staged: sentence rows {[r.size for r in rows]}")
    (sr, wav), counts, rep = run_path(tts, lambda: tts.infer_fast(
        prompt, LONG_SENTENCE, max_text_tokens_per_sentence=200,
        max_mel_tokens=300))
    expect("staged", tts, "staged")
    check_audio("staged", sr, wav, tts.last_sentence_frames.sum(),
                tts.vocoder.upsample)
    check_finite("staged", tts.last_wav)
    rep.update(rows=1, text_tokens=int(rows[0].size))
    return counts, rep


def run_infer(tts: IndexTTS, prompt: str):
    """Sequential infer: three sentences, one decode each."""
    (sr, wav), counts, rep = run_path(
        tts, lambda: tts.infer(prompt, TEXTS[2], max_mel_tokens=200))
    expect("infer", tts, "staged")
    frames = tts.last_sentence_frames
    if frames.size != 3:
        raise AssertionError(f"infer: {frames.size} sentences, want 3")
    check_audio("infer", sr, wav, frames.sum(), tts.vocoder.upsample)
    check_finite("infer", tts.last_wav)
    rep.update(rows=3)
    return counts, rep


def run_infer_batch(tts: IndexTTS, prompt: str):
    """Two infer_batch calls: [TEXTS[0], TEXTS[1]] on the fused route, then
    [TEXTS[0], "", TEXTS[1]] on the staged one. Each text's length is the
    frames of its own sentences."""
    total = {name: 0 for name in COUNTED}
    reports = []
    for texts, path in (([TEXTS[0], TEXTS[1]], "fused"),
                        ([TEXTS[0], "", TEXTS[1]], "staged")):
        outs, counts, rep = run_path(tts, lambda: tts.infer_batch(
            prompt, texts, max_mel_tokens=200))
        expect(f"infer_batch/{path}", tts, path,
               "fused" if path == "fused" else None)
        frames = tts.last_sentence_frames
        n_sent = [max(len(tts.sentence_rows(t, 120)), 1) for t in texts]
        bounds = np.cumsum([0] + n_sent)
        if len(outs) != len(texts) or bounds[-1] != frames.size:
            raise AssertionError(f"infer_batch/{path}: {len(outs)} outputs, "
                                 f"{frames.size} sentences")
        for ti, (sr, wav) in enumerate(outs):
            check_audio(f"infer_batch/{path} text {ti}", sr, wav,
                        frames[bounds[ti]: bounds[ti + 1]].sum(),
                        tts.vocoder.upsample)
        if path == "fused":
            res = tts.last_fused_res
            t = int(res.stream_frames) * tts.vocoder.upsample
            check_finite("infer_batch/fused", res.wav[:t].cpu().numpy())
        else:
            check_finite("infer_batch/staged", tts.last_wav)
        rep.update(rows=len(n_sent), texts=len(texts),
                   samples=[int(w.shape[0]) for _, w in outs])
        reports.append(rep)
        total = {k: total[k] + counts[k] for k in total}
    return total, reports


# ----------------------------------------------------------- the surfaces

# three SRT entries, one of them Chinese (stretch), and two (adaptive)
SRT_STRETCH = """1
00:00:00,000 --> 00:00:02,000
The quick brown fox jumps over the lazy dog.

2
00:00:02,500 --> 00:00:04,000
这是第二段字幕，在显卡上配音。

3
00:00:04,500 --> 00:00:06,000
Hello there, the third line of the film.
"""
SRT_ADAPTIVE = """1
00:00:00,000 --> 00:00:02,000
A short line for the adaptive strategy.

2
00:00:02,500 --> 00:00:04,500
And a second one that follows it.
"""
ADAPTIVE_CAP = 150
N_CANDIDATES = 4                 # IndexTTSEngine.synthesize_to_duration's


class CountedTTS(IndexTTS):
    """The engine as the surfaces build it, counting what reaches it. The
    dubbing strategies catch an engine's exceptions and fall back (a failed
    batch to per-entry calls, a failed entry to silence), so the phases
    count the calls, keep every error, and keep each batched call's codes
    on the one-program route."""

    built: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls, self.errors, self.batch_codes, self.reports = [], [], [], []
        CountedTTS.built.append(self)

    def _counted(self, name, fn, *args, **kwargs):
        self.calls.append(name)
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
        except Exception as e:
            self.errors.append(f"{name}: {e!r}")
            raise
        torch.cuda.synchronize()
        lt = self.last_times
        self.reports.append({
            "call": name, "path": self.last_path,
            "flavor": self.last_fused_flavor if self.last_path == "fused"
            else None, "decode": lt.decode, "steps": lt.decode_steps,
            "audio_s": lt.audio_seconds, "wall_s": time.perf_counter() - t0,
            "rtf": lt.rtf, "gpt_gen_s": lt.gpt_gen, "bigvgan_s": lt.bigvgan,
            "gpt_gen_ms_per_step": 1e3 * lt.gpt_gen / max(lt.decode_steps, 1)})
        return out

    def infer(self, *args, **kwargs):
        return self._counted("infer", super().infer, *args, **kwargs)

    def infer_batch(self, audio_prompt, texts, **kwargs):
        out = self._counted("infer_batch", super().infer_batch, audio_prompt,
                            texts, **kwargs)
        if self.last_path == "fused":
            self.batch_codes.append(
                self.last_fused_res.codes[:len(texts)].cpu())
        return out


class surfaces_built_counted:
    """Within the block every IndexTTS the surfaces build is a CountedTTS
    with bf16 weights (IndexTTSConfig.FP16, the dubbing layer's setting);
    the engines are released after it."""

    def __enter__(self):
        self.saved = tts_mod.IndexTTS, dub_config.IndexTTSConfig.FP16
        tts_mod.IndexTTS = CountedTTS
        dub_config.IndexTTSConfig.FP16 = True
        return CountedTTS.built

    def __exit__(self, *exc):
        tts_mod.IndexTTS, dub_config.IndexTTSConfig.FP16 = self.saved
        CountedTTS.built.clear()
        gc.collect()
        torch.cuda.empty_cache()


def tree_numpy_f32(tree):
    """A tree of tensors as numpy, floating leaves in float32."""
    if isinstance(tree, dict):
        return {k: tree_numpy_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_numpy_f32(v) for v in tree]
    return (tree.float() if tree.is_floating_point() else tree).cpu().numpy()


def leaves(tree, prefix: str = "") -> dict:
    """A tree of tensors as {"a/0/b": tensor}."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def read_wav_i16(path) -> tuple:
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise AssertionError(f"{path}: not mono int16")
        return (np.frombuffer(w.readframes(w.getnframes()), "<i2"),
                w.getframerate())


def surface_launches() -> dict:
    counts = read_counts()
    if min(counts["snake_cmajor"], counts["resblock_cmajor"]) < 1:
        raise AssertionError(f"vocoder kernels did not launch: {counts}")
    return counts


def run_checkpoint(tts: IndexTTS, model_dir: Path) -> dict:
    """The running engine's weights as float32 gpt.npz + bigvgan.npz, then
    IndexTTS(model_dir=..., is_fp16=True) on the card: every leaf equal to
    the running engine's (bf16 → f32 → bf16 is exact)."""
    free = shutil.disk_usage(model_dir).free
    t0 = time.perf_counter()
    for part in ("gpt", "bigvgan"):
        checkpoint.save_params(model_dir / f"{part}.npz",
                               tree_numpy_f32(tts.params[part]))
    write_s = time.perf_counter() - t0
    nbytes = {p.name: p.stat().st_size for p in model_dir.glob("*.npz")}
    t0 = time.perf_counter()
    loaded = IndexTTS(model_dir=str(model_dir), is_fp16=True,
                      verbose_init=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want, got = leaves(tts.params), leaves(loaded.params)
    if got.keys() != want.keys():
        raise AssertionError(f"loaded keys differ: {set(got) ^ set(want)}")
    bad = [k for k in want if got[k].dtype != want[k].dtype
           or got[k].device != want[k].device or not torch.equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"{len(bad)} leaves differ, first {bad[:3]}")
    n_params = sum(v.numel() for v in want.values())
    del loaded
    return {"leaves": len(want), "params": n_params, "bytes": nbytes,
            "disk_free_before": free, "write_s": write_s, "load_s": load_s}


def run_cli(model_dir: Path, prompt: str) -> tuple:
    """indextts-torch (cli.main) with --model_dir --fp16 --fast -f on one
    sentence: the written wav is int16 at 24 kHz, whole frames, not
    constant; K1 and K2 launch."""
    out = model_dir / "cli.wav"
    with surfaces_built_counted() as built:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        rc = cli_mod.main([TEXTS[1], "-v", prompt, "-o", str(out),
                           "--model_dir", str(model_dir), "--fp16", "--fast",
                           "-f"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = surface_launches()
        if rc != 0 or len(built) != 1:
            raise AssertionError(f"cli: rc {rc}, {len(built)} engines built")
        tts = built[0]
        if tts.dtype != torch.bfloat16 or tts.last_path != "fused":
            raise AssertionError(f"cli: {tts.dtype}, route {tts.last_path}")
        lt = tts.last_times
        report = {"route": f"{tts.last_path} ({tts.last_fused_flavor})",
                  "decode": lt.decode, "steps": lt.decode_steps,
                  "audio_s": lt.audio_seconds, "wall_s": wall,
                  "rtf": lt.rtf, "gpt_gen_s": lt.gpt_gen,
                  "bigvgan_s": lt.bigvgan,
                  "gpt_gen_ms_per_step": 1e3 * lt.gpt_gen / lt.decode_steps}
    wav, sr = read_wav_i16(out)
    if sr != 24000 or wav.size == 0 or wav.size % 1024 or wav.min() == wav.max():
        raise AssertionError(f"cli wav: {sr} Hz, {wav.size} samples, "
                             f"range [{wav.min()}, {wav.max()}]")
    report.update(samples=int(wav.size),
                  launches={k: v for k, v in counts.items() if v})
    return counts, report


def check_segments(name: str, segments: list, n: int) -> None:
    """n segments, none the strategies' silence fallback, all finite."""
    if len(segments) != n:
        raise AssertionError(f"{name}: {len(segments)} segments, want {n}")
    for seg in segments:
        audio = np.asarray(seg["audio_data"])
        if not np.isfinite(audio).all() or not np.abs(audio).max() > 0:
            raise AssertionError(f"{name}: entry {seg['index']} is silent or "
                                 "not finite (the silence fallback)")


def run_dubbing_stretch(model_dir: Path, prompt: str) -> tuple:
    """srt-dubbing-torch (dubbing.cli.main) with the stretch strategy on
    three entries: one infer_batch and no other call, no silent segment,
    and the merged wav sounding in every segment's placed span (start, or
    the previous segment's end when they overlap) and in every entry's
    span, at least as long as the last entry's end."""
    srt = model_dir / "stretch.srt"
    srt.write_text(SRT_STRETCH, encoding="utf-8")
    out = model_dir / "stretch.wav"
    segments = []
    real_get_strategy = dub_cli.get_strategy

    def recording_get_strategy(name, engine, **kwargs):
        strategy = real_get_strategy(name, engine, **kwargs)
        inner = strategy.process_entries

        def process(entries, **kw):
            segs = inner(entries, **kw)
            segments.extend(segs)
            return segs

        strategy.process_entries = process
        return strategy

    with surfaces_built_counted() as built:
        dub_cli.get_strategy = recording_get_strategy
        try:
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            rc = dub_cli.main(["--srt", str(srt), "--voice", prompt,
                               "--output", str(out), "--model-dir",
                               str(model_dir), "--strategy", "stretch"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            dub_cli.get_strategy = real_get_strategy
        counts = surface_launches()
        if rc != 0 or len(built) != 1:
            raise AssertionError(f"stretch: rc {rc}, {len(built)} engines")
        tts = built[0]
        if tts.calls != ["infer_batch"] or tts.errors:
            raise AssertionError(f"stretch: engine calls {tts.calls}, "
                                 f"errors {tts.errors}")
        reports = tts.reports
    check_segments("stretch", segments, 3)
    wav, sr = read_wav_i16(out)
    pos = 0
    for seg in sorted(segments, key=lambda s: s["start_time"]):
        start = max(int(seg["start_time"] * sr), pos)
        pos = start + len(seg["audio_data"])
        for a, b in ((start, pos), (int(seg["start_time"] * sr),
                                    int(seg["end_time"] * sr))):
            if not np.abs(wav[a:b]).max() > 0:
                raise AssertionError(f"stretch: silent at [{a}, {b})")
    if sr != 24000 or wav.size < max(pos, int(segments[-1]["end_time"] * sr)):
        raise AssertionError(f"stretch wav: {sr} Hz, {wav.size} samples")
    return counts, {"wall_s": wall, "calls": reports,
                    "segment_samples": [len(s["audio_data"]) for s in segments],
                    "samples": int(wav.size),
                    "launches": {k: v for k, v in counts.items() if v}}


def run_dubbing_adaptive(model_dir: Path, prompt: str) -> tuple:
    """The five stages of the dubbing CLI driven here (the CLI passes no
    decode cap) with the adaptive strategy on two entries and
    max_mel_tokens=150: per entry one infer and one infer_batch of
    N_CANDIDATES rows whose codes differ pairwise, no silent segment."""
    with surfaces_built_counted() as built:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        engine = dub_engines.get_tts_engine("index_tts",
                                            model_dir=str(model_dir))
        entries = SRTParser().parse_content(SRT_ADAPTIVE)
        strategy = dub_strategies.get_strategy("adaptive", engine)
        segments = strategy.process_entries(entries, voice_reference=prompt,
                                            max_mel_tokens=ADAPTIVE_CAP)
        processor = AudioProcessor(sample_rate=engine.tts.cfg.mel.sample_rate)
        merged = processor.merge_audio_segments(segments, "adaptive")
        if not processor.export_audio(merged, str(model_dir / "adaptive.wav")):
            raise AssertionError("adaptive: export failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = surface_launches()
        if len(built) != 1:
            raise AssertionError(f"adaptive: {len(built)} engines built")
        tts = built[0]
        if tts.calls != ["infer", "infer_batch"] * 2 or tts.errors:
            raise AssertionError(f"adaptive: engine calls {tts.calls}, "
                                 f"errors {tts.errors}")
        for codes in tts.batch_codes:
            if codes.shape != (N_CANDIDATES, ADAPTIVE_CAP):
                raise AssertionError(f"adaptive: candidates {codes.shape}")
            same = [(i, j) for i in range(N_CANDIDATES) for j in range(i)
                    if torch.equal(codes[i], codes[j])]
            if same:
                raise AssertionError(f"adaptive: candidate rows equal {same}")
        if len(tts.batch_codes) != 2:
            raise AssertionError("adaptive: a batch left the one-program route")
        reports = tts.reports
    check_segments("adaptive", segments, 2)
    if merged.size != sum(len(s["audio_data"]) for s in segments) \
            or merged.min() == merged.max():
        raise AssertionError(f"adaptive merged: {merged.size} samples")
    return counts, {"wall_s": wall, "calls": reports,
                    "segment_samples": [len(s["audio_data"]) for s in segments],
                    "launches": {k: v for k, v in counts.items() if v}}


# ------------------------------------------------ slice 8: the new paths

# tests/test_engine.py's small_config(): BigVGAN stages of 64 … 2 channels,
# every one on K2 at a padded width
SMALL_GPT = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=60,
                 max_text_tokens=50, number_text_tokens=120,
                 cond_output_size=32, cond_linear_units=64,
                 cond_attention_heads=4, cond_num_blocks=2)
SMALL_BV = dict(gpt_dim=64, upsample_initial_channel=128)
# four texts of 1, 2, 4 and 5 sentences (12 rows at CB_SPLIT tokens a
# sentence) for continuous batching
CB_TEXTS = [
    "A single short line.",
    "Two lines now. The second one ends here.",
    "Four lines here. Each of them is short. The third follows. And the "
    "last one ends the text.",
    "Five lines close the set. They run one after another. A slot frees "
    "when a line ends. The next line takes it. That is continuous batching.",
]
CB_SPLIT = 30
CB_CAP = 200
TRACE_STEPS = 32            # decode steps inside each traced window
TRACE_FROM = 64             # the trunk call that opens the window
TRACE_CAP = 160
GAP_TOL = 1e-4              # top-2 logit gap, relative, that counts as a tie


def run_small(prompt: str):
    """small_config() on the card in float32: one infer_fast on the
    one-program route, K2 launched at every C ≤ 128 stage (64 … 2, padded
    to 64, 32, 16, 8, 8, 8), its wav within VOCODER_TOL of the exact route
    over the same latents."""
    cfg = EngineConfig(gpt=replace(EngineConfig().gpt, **SMALL_GPT),
                       bigvgan=replace(EngineConfig().bigvgan, **SMALL_BV))
    tts = IndexTTS(config=cfg, seed=0, verbose_init=False)
    widths = []
    real = voc_mod.resblock_cmajor

    def recording(x, *args, **kwargs):
        widths.append(x.shape[1])
        return real(x, *args, **kwargs)

    text = f"{TEXTS[0]} {TEXTS[1]}"
    voc_mod.resblock_cmajor = recording
    try:
        (sr, wav), counts, rep = run_path(tts, lambda: tts.infer_fast(
            prompt, text, max_text_tokens_per_sentence=40, max_mel_tokens=60))
    finally:
        voc_mod.resblock_cmajor = real
    expect("small/infer_fast", tts, "fused", "fused")
    stages = [cfg.bigvgan.stage_channels(i)
              for i in range(cfg.bigvgan.num_upsamples)]
    if sorted(set(widths), reverse=True) != stages or max(stages) > 128:
        raise AssertionError(f"small: K2 ran at {sorted(set(widths))}, "
                             f"stages {stages}")
    res, voc = tts.last_fused_res, tts.vocoder
    lens = res.lens.cpu().numpy()
    t = int(res.stream_frames)
    if not t >= voc.window + 2 * voc.halo:
        raise AssertionError(f"small: {t} frames take the short fallback")
    check_audio("small", sr, wav, lens.sum(), voc.upsample)
    stream = torch.cat([res.lat[i, :lens[i]] for i in range(len(lens))])
    spk = tts._speaker(tts._cond_mel(prompt))
    exact = voc_mod._vocode_window_cmajor(
        tts.params["bigvgan"], tts.bigvgan_cfg, stream[None].float(), spk,
        use_kernels=False)[0].cpu().numpy()
    got = res.wav[: t * voc.upsample].cpu().numpy()
    err = float(np.abs(got - exact).max())
    if not err <= VOCODER_TOL:
        raise AssertionError(f"small vs exact: {err} > {VOCODER_TOL}")
    rep.update(stages=stages, k2_widths=sorted(set(widths), reverse=True),
               k2_padded=[k2.kernel_width(c) for c in stages],
               stream_frames=t, vs_exact=err)
    return counts, rep


def tree_bytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in leaves(tree).values())


def run_int8(tts: IndexTTS, prompt: str):
    """IndexTTS(quantize="int8") on the bf16 engine's weights beside the
    bf16 engine: one infer_fast at the reference's defaults and cap 200 on
    each, in turns (bf16, int8, int8, bf16), every run from one generator
    seed; ms a step, the trees' bytes and the share of equal tokens
    (printed, not asserted)."""
    q = IndexTTS(config=tts.cfg, is_fp16=True, params=tts.params,
                 quantize="int8", verbose_init=False)
    blk = q.params["gpt"]["blocks"][0]["attn"]["qkv"]
    if blk["w_q"].dtype != torch.int8 or blk["scale"].dtype != torch.float32:
        raise AssertionError("int8: the trunk is not quantised")
    matmuls = lambda g: [g["mel_head"]] + [b[grp][n] for b in g["blocks"]
                                            for grp, names in (
                                                ("attn", ("qkv", "proj")),
                                                ("mlp", ("fc", "proj")))
                                            for n in names]
    runs = {"bf16": [], "int8": []}
    total = {name: 0 for name in COUNTED}
    codes = {}
    for name, eng in (("bf16", tts), ("int8", q), ("int8", q), ("bf16", tts)):
        eng._generator.manual_seed(5)
        _, counts, rep = run_path(eng, lambda: eng.infer_fast(
            prompt, TEXTS[1], max_mel_tokens=CB_CAP))
        expect(f"int8/{name}", eng, "fused", "fused")
        runs[name].append(rep)
        codes.setdefault(name, eng.last_fused_res.codes[:1].cpu())
        if name == "int8":
            total = {k: total[k] + counts[k] for k in total}
    same = codes["bf16"] == codes["int8"]
    out = {"runs": runs,
           "ms_per_step": {k: [r["gpt_gen_ms_per_step"] for r in v]
                           for k, v in runs.items()},
           "gpt_bytes": {"bf16": tree_bytes(tts.params["gpt"]),
                         "int8": tree_bytes(q.params["gpt"])},
           "matmul_bytes": {"bf16": tree_bytes(matmuls(tts.params["gpt"])),
                            "int8": tree_bytes(matmuls(q.params["gpt"]))},
           "equal_tokens": int(same.sum()), "of": same.numel()}
    del q
    gc.collect()
    torch.cuda.empty_cache()
    return total, out


def processed_logits_at(params, cfg, sc, emb, keep, codes, step):
    """``generate``'s processed logits for one row at decode ``step``,
    teacher-forced on that row's ``codes``."""
    s0 = emb.shape[1]
    dev = emb.device
    cache = gpt_model.init_cache(cfg, 1, s0 + step + 1, emb.dtype, dev)
    h = gpt_model.trunk_prefill(params, cfg, emb, keep, cache)
    kk = torch.cat([keep, torch.zeros((1, step + 1), dtype=torch.bool,
                                      device=dev)], dim=1)
    seen = torch.zeros((1, cfg.number_mel_codes), dtype=torch.bool, device=dev)
    seen[:, sc.fake_prefix_id] = True
    seen[:, cfg.start_mel_token] = True
    for j in range(1, step + 1):
        tok = int(codes[j - 1])
        seen[0, tok] = True
        e = (params["mel_emb"]["w"][tok] + params["mel_pos"]["w"][j + 1]
             ).to(emb.dtype)[None]
        kk[:, s0 + j - 1] = True
        h = gpt_model.trunk_decode_step(params, cfg, e, cache, s0 + j - 1, kk)
    return decode_mod._process_logits(
        gpt_model.mel_logits_from_hidden(params, h), seen, sc)[0]


def cb_vs_generate(tts: IndexTTS, conds, rows) -> dict:
    """Float32 greedy: continuous batching (2 slots, so slots refill) row for
    row against ``generate`` on each row alone, at cap 64, TF32 off. A
    differing row must differ at a near-tie of ``generate``'s logits (top-2
    gap under GAP_TOL relative)."""
    cfg = tts.gpt_cfg
    p32 = weights.cast_floating(tts.params["gpt"], torch.float32)
    c32 = conds.float()
    sc = replace(tts._sampling_config({}), do_sample=False, max_mel_tokens=64)
    batcher = cb.ContinuousBatcher(p32, cfg, sc, c32, batch=2,
                                   text_buckets=tts.TEXT_BUCKETS)
    got = batcher.run([cb.CBRequest(uid=i, text_ids=r)
                       for i, r in enumerate(rows)], dtype=torch.float32)
    out = {"rows": len(rows), "steps": 64, "refills": batcher.stats["refills"],
           "equal_rows": 0, "ties": []}
    for i, r in enumerate(rows):
        pad_to = next((b for b in tts.TEXT_BUCKETS if b >= r.size), r.size)
        pre = decode_mod.prepare_prefix_host(cfg, [r], pad_to=pad_to)
        t = lambda k: torch.as_tensor(pre[k].astype(np.int64), device="cuda")
        emb, keep = decode_mod.build_prefix_emb(p32, cfg, c32, t("ids"),
                                                t("pos"), t("seg"),
                                                t("cond_idx"))
        ref = decode_mod.generate(p32, cfg, sc, emb, keep)
        ref_codes = ref.codes[0].cpu().numpy()
        codes, ln = got[i]
        n = min(ln, int(ref.lengths[0]))
        diff = np.nonzero(codes[:n] != ref_codes[:n])[0]
        if ln == int(ref.lengths[0]) and not diff.size:
            out["equal_rows"] += 1
            continue
        step = int(diff[0]) if diff.size else n
        top = torch.topk(processed_logits_at(p32, cfg, sc, emb, keep,
                                             ref_codes, step), 2).values
        gap = float((top[0] - top[1]) / top[0].abs().clamp_min(1e-30))
        out["ties"].append({"row": i, "step": step, "gap": gap})
        if not gap < GAP_TOL:
            raise AssertionError(f"continuous row {i} differs from generate "
                                 f"at step {step}, top-2 gap {gap}")
    del p32
    return out


def run_continuous(tts: IndexTTS, prompt: str):
    """infer_batch(continuous=True, cb_slots=8) on CB_TEXTS (12 sentences)
    beside infer_batch(num_beams=1) on the same texts (both sample per
    row); then the ContinuousBatcher with per-request caps from 40 to 200;
    then the float32 greedy check against generate."""
    n_sent = [len(tts.sentence_rows(t, CB_SPLIT)) for t in CB_TEXTS]
    if sum(n_sent) != 12:
        raise AssertionError(f"continuous: sentences {n_sent}")
    out, total = {}, {name: 0 for name in COUNTED}
    for name, kw, path in (("continuous", dict(continuous=True, cb_slots=8),
                            "staged"),
                           ("batch", dict(num_beams=1), "fused")):
        outs, counts, rep = run_path(tts, lambda: tts.infer_batch(
            prompt, CB_TEXTS, max_mel_tokens=CB_CAP,
            max_text_tokens_per_sentence=CB_SPLIT, **kw))
        expect(f"continuous/{name}", tts, path, "fused" if path == "fused"
               else None)
        frames = tts.last_sentence_frames
        bounds = np.cumsum([0] + n_sent)
        for ti, (sr, wav) in enumerate(outs):
            check_audio(f"continuous/{name} text {ti}", sr, wav,
                        frames[bounds[ti]: bounds[ti + 1]].sum(),
                        tts.vocoder.upsample)
        if name == "continuous":
            rep["cb_stats"] = tts.last_cb_stats
            check_finite("continuous", tts.last_wav)
        out[name] = rep
        total = {k: total[k] + counts[k] for k in total}

    rows = [r for t in CB_TEXTS for r in tts.sentence_rows(t, CB_SPLIT)]
    caps = [int(c) for c in np.linspace(40, CB_CAP, len(rows))]
    sc = tts._sampling_config(dict(num_beams=1, max_mel_tokens=CB_CAP))
    conds = tts._conditioning(tts._cond_mel(prompt))
    batcher = cb.ContinuousBatcher(tts.params["gpt"], tts.gpt_cfg, sc, conds,
                                   batch=8, text_buckets=tts.TEXT_BUCKETS,
                                   generator=tts._generator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = batcher.run([cb.CBRequest(uid=i, text_ids=r, max_new=c)
                       for i, (r, c) in enumerate(zip(rows, caps))],
                      dtype=tts.dtype)
    wall = time.perf_counter() - t0
    lens = [res[i][1] for i in range(len(rows))]
    if any(not 0 <= ln <= c for ln, c in zip(lens, caps)):
        raise AssertionError(f"continuous caps {caps}, lengths {lens}")
    st = batcher.stats
    out["batcher"] = dict(st, caps=caps, lengths=lens, wall_s=wall,
                          ms_per_step=1e3 * wall / max(st["steps"], 1))
    out["float32_vs_generate"] = cb_vs_generate(tts, conds, rows[:4])
    return total, out


def run_legacy_cond(tts: IndexTTS, prompt: str):
    """A full-width v1.0 tree (the legacy encoder: 6 attention blocks of 16
    heads, random proj and one block's relative positions; the perceiver
    over 1024-wide contexts) on the bf16 engine's other weights: its float32
    get_conditioning on the card within 1e-3 relative of the CPU's, then one
    infer_fast at cap 100 on a bf16 engine."""
    g = tts.gpt_cfg
    cfg = replace(tts.cfg, gpt=replace(g, condition_type="perceiver",
                                       cond_num_blocks=6))
    r = weights.Init(torch.Generator("cuda").manual_seed(7), "cuda")
    d = g.model_dim
    cond = legacy_cond.init(r, 100, d, 6, g.heads)
    for blk in cond["blocks"]:
        blk["proj"] = {"w": r.normal((1, d, d)), "b": r.normal((d,))}
    cond["blocks"][0]["rel_pos"] = {"emb": {"w": r.normal((32, g.heads), 0.5)}}
    v1 = {"cond_encoder": cond,
          "perceiver": weights.init_perceiver(r, d, d, g.condition_num_latent,
                                              64, g.cond_attention_heads,
                                              g.perceiver_mult)}
    mel = tts._cond_mel(prompt).transpose(1, 2).float()
    lens = torch.tensor([mel.shape[1]])
    card = gpt_model.get_conditioning(v1, cfg.gpt, mel, lens.cuda()).cpu()
    cpu = gpt_model.get_conditioning(weights.from_jax_params(v1, "cpu"),
                                     cfg.gpt, mel.cpu(), lens)
    rel = float((card - cpu).abs().max() / cpu.abs().max())
    if not rel <= 1e-3:
        raise AssertionError(f"legacy-cond: card vs CPU {rel} relative")
    params = {"gpt": dict(tts.params["gpt"], **v1),
              "bigvgan": tts.params["bigvgan"]}
    eng = IndexTTS(config=cfg, is_fp16=True, params=params, verbose_init=False)
    (sr, wav), counts, rep = run_path(eng, lambda: eng.infer_fast(
        prompt, TEXTS[1], max_mel_tokens=100))
    expect("legacy-cond", eng, "fused", "fused")
    check_audio("legacy-cond", sr, wav, eng.last_sentence_frames.sum(),
                eng.vocoder.upsample)
    rep.update(conditioning_card_vs_cpu=rel, cond_blocks=6, heads=g.heads)
    del eng
    return counts, rep


def run_trace(tts: IndexTTS, prompt: str, tmp: Path) -> dict:
    """One request's gpt_gen split into conditioning, prefill + decode, trim
    and latent pass, stage by stage. Then TRACE_STEPS decode steps (from
    trunk call TRACE_FROM of a TRACE_CAP-step beam decode, so the gen cache
    is the request's own) of the BN 12 request and of a BN 3 one, each
    window once plain and once under profiling.trace: the device busy time
    (the union of device intervals in the trace), the idle share over the
    traced window's wall and over the plain window's, ms a step of both,
    and the top-10 device ops."""
    params, cfg = tts.params["gpt"], tts.gpt_cfg

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        return val, time.perf_counter() - t0

    split = {}
    tts.cache_cond_mel = None                  # the prompt's mel anew
    cond_mel, split["cond_mel_s"] = timed(lambda: tts._cond_mel(prompt))
    conds, split["conditioning_s"] = timed(lambda: tts._conditioning(cond_mel))
    _, split["speaker_s"] = timed(lambda: tts._speaker(cond_mel))
    sc = tts._sampling_config(dict(max_mel_tokens=CB_CAP))
    x = tts.fused_batch(tts.sentence_rows(TEXTS[1]))

    def decode():
        emb, keep = decode_mod.build_prefix_emb(params, cfg, conds, x["ids"],
                                                x["pos"], x["seg"],
                                                x["cond_idx"])
        return decode_mod._beam_decode(params, cfg, sc, emb, keep,
                                       tts._generator, 3, 0.0,
                                       stochastic=True, live=x["live"])
    res, split["prefill_decode_s"] = timed(decode)
    (codes, lens), split["trim_s"] = timed(
        lambda: tts_mod.remove_long_silence_device(res.codes,
                                                   cfg.stop_mel_token))
    _, split["latent_s"] = timed(lambda: gpt_model.forward_latent_bucketed(
        params, cfg, conds, x["text"], x["text_lens"], codes, lens))
    split.update(steps=res.steps, rows=int(x["live"].sum()),
                 ms_per_step=1e3 * split["prefill_decode_s"] / res.steps)
    out = {"gpt_gen_split": split}

    sc = replace(sc, max_mel_tokens=TRACE_CAP)
    real = gpt_model.trunk_decode_step_split_anc
    for name, text in (("bn12", TEXTS[2]), ("bn3", TEXTS[1])):
        x = tts.fused_batch(tts.sentence_rows(text))
        emb, keep = decode_mod.build_prefix_emb(params, cfg, conds, x["ids"],
                                                x["pos"], x["seg"],
                                                x["cond_idx"])
        walls = {}
        for traced in (False, True):
            window = {"calls": 0}
            stack = contextlib.ExitStack()

            def step(*args, **kwargs):
                window["calls"] += 1
                if window["calls"] in (TRACE_FROM, TRACE_FROM + TRACE_STEPS):
                    torch.cuda.synchronize()
                    if window["calls"] == TRACE_FROM:
                        if traced:
                            stack.enter_context(
                                profiling.trace(str(tmp / name)))
                        window["t0"] = time.perf_counter()
                    else:
                        window["wall"] = time.perf_counter() - window["t0"]
                        stack.close()
                return real(*args, **kwargs)

            gpt_model.trunk_decode_step_split_anc = step
            try:
                decode_mod._beam_decode(params, cfg, sc, emb, keep,
                                        tts._generator, 3, 0.0,
                                        stochastic=True, live=x["live"])
            finally:
                gpt_model.trunk_decode_step_split_anc = real
                stack.close()
            walls[traced] = window["wall"]
        busy_us, by_name = profiling.device_activity(tmp / name /
                                                     "trace.json")
        busy = busy_us / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        out[name] = {"bn": emb.shape[0] * 3, "steps": TRACE_STEPS,
                     "window_from": TRACE_FROM, "cap": TRACE_CAP,
                     "ms_per_step": 1e3 * walls[False] / TRACE_STEPS,
                     "traced_ms_per_step": 1e3 * walls[True] / TRACE_STEPS,
                     "device_busy_ms_per_step": 1e3 * busy / TRACE_STEPS,
                     "idle_share": 1.0 - busy / walls[False],
                     "idle_share_traced": 1.0 - busy / walls[True],
                     "top10_device_ms": [[k[:90], v / 1e3] for k, v in top]}
    return out


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
    k2_widths = check_k2_widths(torch.Generator("cuda").manual_seed(4))
    phase("kernels/k2-widths", t1, json.dumps([
        {k: r[k] for k in ("C", "Cp", "k", "tt", "max_abs_err", "ms",
                           "plain_ms", "bound_ms")}
        for r in k2_widths if r["dtype"] == "torch.float32"]))
    t1 = time.perf_counter()
    ragged = check_ragged(torch.Generator("cuda").manual_seed(3))
    phase("kernels/ragged", t1, "(K1 and B3 within TOL of their plain "
          f"versions at {len(ragged['snake_cmajor'])} + "
          f"{len(ragged['snake_clast'])} ragged cases)")
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

        t1 = time.perf_counter()
        ref_report = run_vocoder_ref(tts)
        paths["vocoder-ref"] = ref_report["launches"]
        phase("main/vocoder-ref", t1, json.dumps(ref_report))

        spk = tts.vocoder.speaker_embedding(tts._cond_mel(prompt).transpose(1, 2))
        for name, run in (("fused", lambda: run_fused(tts, prompt, spk)),
                          ("fused-short",
                           lambda: run_fused_short(tts, prompt, spk)),
                          ("staged", lambda: run_staged(tts, prompt)),
                          ("infer", lambda: run_infer(tts, prompt)),
                          ("infer_batch", lambda: run_infer_batch(tts, prompt))):
            t1 = time.perf_counter()
            paths[name], report = run()
            phase(f"main/{name}", t1, json.dumps(report))
        phase("main", t0)

        t0 = time.perf_counter()
        for name, run in (("small/infer_fast", lambda: run_small(prompt)),
                          ("int8", lambda: run_int8(tts, prompt)),
                          ("continuous", lambda: run_continuous(tts, prompt)),
                          ("legacy-cond", lambda: run_legacy_cond(tts, prompt))):
            t1 = time.perf_counter()
            paths[name], report = run()
            phase(name, t1, json.dumps(report))
            gc.collect()
            torch.cuda.empty_cache()
        phase("slice8", t0)

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as model_dir:
            model_dir = Path(model_dir)
            t1 = time.perf_counter()
            phase("surface/checkpoint", t1,
                  json.dumps(run_checkpoint(tts, model_dir)))
            for name, run in (("cli", run_cli),
                              ("dubbing-stretch", run_dubbing_stretch),
                              ("dubbing-adaptive", run_dubbing_adaptive)):
                t1 = time.perf_counter()
                paths[f"surface/{name}"], report = run(model_dir, prompt)
                phase(f"surface/{name}", t1, json.dumps(report))
        phase("surface", t0)

        # last: the profiler's tracing may slow what runs after it
        t0 = time.perf_counter()
        phase("trace", t0, json.dumps(run_trace(tts, prompt, Path(tmp))))

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
        summarize(checks["snake_clast"], paths["vocoder-ref"]["snake_clast"],
                  "snake_clast",
                  "index_tts_dubbing_tpu_torch/csrc/snake_clast.cu",
                  "index_tts_dubbing_tpu/ops/pallas_snake.py:221"),
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
                                 "snake_clast", "copy_on_fork")):
        k["launches_by_path"] = by_path(name)
    kernels[0]["launches_note"] = kernels[1]["launches_note"] = (
        "launches: the default beam path (three requests); every path in "
        "launches_by_path")
    kernels[2]["launches_note"] = ("launches: the vocoder-ref stream "
                                   "(stream_device, 600 frames)")
    kernels[3]["launches_note"] = "launches: the beam-cof decode"
    kernels[1]["widths"] = k2_widths
    kernels[0]["ragged"] = ragged["snake_cmajor"]
    kernels[2]["ragged"] = ragged["snake_clast"]
    kernels[4]["launches_by_path"] = gathers
    print(json.dumps({"kernels": kernels}))
    phase("total", t_all)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
