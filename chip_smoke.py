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
             k1-stages: K1 against its plain version at the C <= 128
             stages' shapes (K1_STAGE_SHAPES: 96/48/24 channels at
             36864/73728/147456 samples, a window batch of 4), which it runs
             with use_pallas and not fuse_resblocks, float32 and bfloat16
             within TOL, each timed beside its plain version and bound with
             its launch plan; K1's float32 ms per window batch on that route.
             k2-widths: K2 against its plain version at C in K2_WIDTHS (2 …
             128, each run on its padded width) × k in (3, 7, 11), float32
             and bfloat16, 2 windows of 4700 samples, timed in float32
             beside its plain version; C = 129 must raise.
             anc-attention: K3 (the beam step's ancestry attention)
             against its plain version at the line's, the scene's and
             IndexTTS-2's scene's shapes (ANC_SHAPES), float32 and
             bfloat16, at the first, a middle, the second-to-last and the
             last slot with a random ancestry map: the written K/V slot bit
             for bit, o within ANC_TOL; each timed beside its plain
             version, its bound (the live K/V bytes) and one
             scaled_dot_product_attention over the same gathered keys.
             step-norm: K4's two entries (the beam step's bias, residual,
             LayerNorm and GELU chains) against their plain versions at
             the four IndexTTS cells' shapes (STEP_NORM_SHAPES: 3 and 48
             rows of 1024 and 1280 in their dtypes; bias_gelu at 4C): the
             residual written over y bit for bit, LayerNorm and GELU
             within STEP_NORM_TOL; each timed as a graph replay beside its
             plain version and its bytes bound.
4. main    - full-width EngineConfig(), bf16 random weights from seed 0, a
             3 s numpy prompt. Two paths, each with every launch count set
             to 0 just before it and read just after:
             sampling  - one IndexTTS.infer_fast(num_beams=1) request;
             beam      - three infer_fast requests with the reference's
                         defaults (num_beams=3, beam sampling):
                         warm-up, one sentence, and three sentences padded
                         to a batch bucket with a dead row; copy_on_fork
                         never launches.
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
7. slice 9 - after slice 8, before the surfaces; each path with every launch
             count set to 0 just before it and read just after:
             dvae-eval   - dvae at DVAEConfig() with random weights (card
                         codes equal the CPU's, the decoded mel within
                         DVAE_TOL), sinc_conv card vs CPU, speaker_similarity
                         of the prompt and a sampling request's wav
                         (TEXTS[1] at cap 300), and
                         forward_latent against forward_latent_bucketed on one
                         sentence in float32.
8. slice 10 - after slice 9, before the surfaces:
             mesh-serve  - two ranks of this script (--mesh-rank, started by
                         the phase after the kernels are built, so they load
                         them) on the one card, gloo over TCP on 127.0.0.1
                         with CUDA tensors (NCCL refuses two ranks on one
                         device): IndexTTS(is_fp16=True, seed=0,
                         mesh=make_mesh(1, 2)) serves one infer_fast with
                         the reference's defaults at cap 80 on the staged
                         route (TEXTS[2], three sentences: 240 frames, so
                         the stream vocodes in windows on K1 and K2); each rank's wav checked, the two equal, K1,
                         K2 and K4's two entries launched on each rank and
                         B4 on none; float32
                         greedy generate at cap 64 on four rows at (1, 2)
                         and (2, 1) against this process's (equal, or
                         parting first at a near-tie under GAP_TOL); ms a
                         step of the mesh's beam and greedy decodes beside
                         one process's. A rank that fails or passes
                         MESH_RANK_TIMEOUT fails the phase;
             train-gpt   - five train_steps of the full-width GPT in float32
                         (batch 4: a 3 s mel, 64 text tokens, 200 codes; lr
                         1e-3, warmup 1): finite, falling losses, ms a step,
                         max_memory_allocated; the small config's two steps
                         on the card within TRAIN_TOL of the CPU's;
             train-vocoder - the generator's and discriminators' totals with
                         backward on 1.5 s of that sampling request's wav:
                         finite, ms each; the generator total within
                         LOSS_RTOL of the CPU's on 0.25 s.
9. slice 11 - after slice 10, before the surfaces; the vocoder's switches
             (use_pallas: K1, fuse_resblocks: K2, edge_exact) and the last
             modules of the JAX package:
             switches    - stream_device on the multi request's first row
                         (600 frames, two window batches) through the bf16
                         engine's weights with (use_pallas, fuse_resblocks,
                         edge_exact) = TTT, TFT, FTT and TTF, each counted
                         from zero: K1 55 / 109 / 0 / 55 and K2 9 / 0 / 9 / 9
                         per window batch, nothing else; each within
                         VOCODER_TOL of the exact route EDGE_FRAMES from the
                         ends, over the whole wav within VOCODER_TOL with
                         edge_exact and EDGE_TOL without; TTF equal to TTT
                         bit for bit but for the first and last halo·1024
                         samples, and different in both;
             infer_fast-k1 - infer_fast on the one-program flavour (TEXTS[2]
                         at max_mel_tokens=256) with tts.vocoder set to TFT:
                         K1 109 per window batch, K2 none, the usual int16
                         checks, the wav within VOCODER_TOL of the same
                         vocoder's stream_device;
             window-ms   - float32 ms of one window batch of 4 through each
                         setting and the exact route, and of the edge patches;
             heads       - the conformer's five other input layers (idim
                         100, odim 512) and ECAPA's classifier head (512 →
                         1211, lin_blocks 0 and 1) on the card within
                         HEADS_TOL of the CPU, the masks equal.
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
import socket
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
from index_tts_dubbing_tpu_torch.config import EngineConfig, MelVocoderConfig
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
from index_tts_dubbing_tpu_torch.eval import speaker_sim
from index_tts_dubbing_tpu_torch.models import bigvgan as bigvgan_mod
from index_tts_dubbing_tpu_torch.models import bigvgan_disc as disc
from index_tts_dubbing_tpu_torch.models import conformer
from index_tts_dubbing_tpu_torch.models import dvae, ecapa
from index_tts_dubbing_tpu_torch.models import gpt as gpt_model
from index_tts_dubbing_tpu_torch.models import legacy_cond
from index_tts_dubbing_tpu_torch.ops import anc_attention as k3
from index_tts_dubbing_tpu_torch.ops import cuda_lib
from index_tts_dubbing_tpu_torch.ops import permute
from index_tts_dubbing_tpu_torch.ops import resblock_cmajor as k2
from index_tts_dubbing_tpu_torch.ops import sinc_conv
from index_tts_dubbing_tpu_torch.ops import snake_clast as b3
from index_tts_dubbing_tpu_torch.ops import snake_cmajor as k1
from index_tts_dubbing_tpu_torch.ops import step_norm as k4
from index_tts_dubbing_tpu_torch.parallel import mesh as mesh_lib
from index_tts_dubbing_tpu_torch.training import step as train_mod
from index_tts_dubbing_tpu_torch.training import vocoder_losses as vl
from index_tts_dubbing_tpu_torch.utils import checkpoint, profiling
from index_tts_dubbing_tpu_torch.utils.audio import load_audio, write_wav

WATCHDOG_S = 1150
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # dense bf16 tensor cores
TF32_OPS_PER_S = 495e12          # dense TF32 tensor cores
WINDOW_BATCH = 4                 # windows per vocoder call in the checks
# K1 per window batch: 18 activations in each C > 128 stage, plus act_post
K1_SHAPES = [(768, 576, 18), (384, 2304, 18), (192, 9216, 18), (24, 147456, 1)]
# K2 per window batch: one resblock per kernel size in each C <= 128 stage
# K1 per window batch also at the C <= 128 stages when it runs without K2
# (use_pallas without fuse_resblocks): 18 activations a stage, 109 in all
K1_STAGE_SHAPES = [(96, 36864, 18), (48, 73728, 18), (24, 147456, 18)]
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
# K3 at the cells' shapes (B, H, D, S0, G): the line's one row and the
# scene's 16 rows, 3 beams, at cap 164 (G = the cap), and scene.v2-bf16's
# 16 rows of 20 heads at cap 350 (S0: 34 conditioning rows, a 40-token line
# with start and stop, start_mel)
ANC_SHAPES = {"line": (1, 16, 64, 70, 164), "scene": (16, 16, 64, 80, 164),
              "v2scene": (16, 20, 64, 77, 350)}
# |K3 - plain| <= ANC_TOL * max|plain| (tests/test_torch_anc_attention.py):
# float32 sums in another order; bfloat16 rounds o once where the plain
# chain rounds three times, and a weight at a bf16 rounding edge may round
# the other way
ANC_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# K4 at the cells' step shapes (rows, C, dtype): the line's 1 × 3 beams and
# the scene's 16 × 3 of IndexTTS-1.5 at 1024, IndexTTS-2's scene at 1280
STEP_NORM_SHAPES = {"line-bf16": (3, 1024, torch.bfloat16),
                    "line-f32": (3, 1024, torch.float32),
                    "scene-f32": (48, 1024, torch.float32),
                    "v2scene-bf16": (48, 1280, torch.bfloat16)}
# |K4 - plain| <= rtol·|plain| + atol elementwise
# (tests/test_torch_step_norm.py): the LayerNorm's float32 statistics sum in
# another order, which can move an output across a rounding edge (an ulp of
# bfloat16 is at most 2^-7 of the value); GELU is the same float32 ops
STEP_NORM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}
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


def check_k1_stages(gen: torch.Generator) -> list:
    """K1 against its plain version at the C <= 128 stages' shapes
    (K1_STAGE_SHAPES, one window batch of 4), float32 and bfloat16, within
    TOL; each timed beside its plain version and its bound, with its launch
    plan."""
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dt).element_size()
        for c, t, per_batch in K1_STAGE_SHAPES:
            x = rand(WINDOW_BATCH, c, t).to(dt)
            al, be = rand(c) * 0.3, rand(c) * 0.3
            ref = k1.snake_cmajor_plain(x, al, be, True).float()
            got = k1.snake_cmajor(x, al, be, True).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            lim = TOL[dt] * max(1.0, ref.abs().max().item())
            if not err <= lim:
                raise AssertionError(f"K1 {dt} C={c} T={t}: err {err} > {lim}")
            vec, lanes, passes, chunk = k1.launch_plan(x)
            n = WINDOW_BATCH * c * t
            bound, by = bound_ms(2 * n * es + 8 * c, n * ACT_OPS)
            rows.append({
                "dtype": str(dt), "C": c, "T": t, "per_batch": per_batch,
                "max_abs_err": err, "tol": lim, "vec": vec, "lanes": lanes,
                "passes": passes, "chunk": chunk,
                "ms": cuda_ms(lambda: k1.snake_cmajor(x, al, be, True), 10),
                "plain_ms": cuda_ms(
                    lambda: k1.snake_cmajor_plain(x, al, be, True), 3),
                "bound_ms": bound, "bound_by": by})
            del x, ref, got
    return rows


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


# The exact work the cells run, as (name, vocoder, batch, frames): the
# ×1024 vocoder's two 32-frame edge patches and a 35- and a 143-frame
# stream vocoded whole; the ×256 mel vocoder's 32 patches of 76 frames (the
# 16-line scene's) and a 188-frame line.
EXACT_WORK = [("patches32", "indextts", 2, 32), ("stream35", "indextts", 1, 35),
              ("stream143", "indextts", 1, 143),
              ("f5_patches76", "f5", 32, 76), ("f5_line188", "f5", 1, 188)]
EXACT_RATES = {"indextts": (4, 4, 4, 4, 2, 2), "f5": (4, 4, 2, 2, 2, 2)}
# tensors shorter than a run, under K2's chain span and under twice it, as
# (C, T): one K2 tile reaches both ends
EXACT_SHORT = [(24, 1), (24, 5), (96, 40), (96, 150), (48, 190)]


def summarize_exact(exact: dict) -> dict:
    """Per case of EXACT_WORK: the float32 ms of one exact batch's K1 and
    K2 launches (18 a C > 128 stage, act_post once, K2 once per k and
    stage) beside the exact route's; the worst error per kernel and
    dtype."""
    per = {}
    for kernel, rows in exact.items():
        for r in rows:
            if "ms" not in r:
                continue
            n = 1 if kernel == "resblock_cmajor" or r["shape"][1] == 24 \
                else 18
            d = per.setdefault(r["case"], {"kernels_ms": 0.0,
                                           "exact_route_ms": 0.0})
            d["kernels_ms"] += n * r["ms"]
            d["exact_route_ms"] += n * r["exact_route_ms"]
    worst = {kernel: {dt: max(r["max_abs_err"] for r in rows
                              if r["dtype"] == dt)
                      for dt in ("torch.float32", "torch.bfloat16")}
             for kernel, rows in exact.items()}
    return {"per_batch": per, "max_abs_err": worst}


def exact_launches(rates, b: int, frames: int):
    """K1's (C, T) and K2's (C, T) launches of one exact batch: K1 at the
    C > 128 stages (18 activations each) and act_post, K2 at the rest."""
    k1_shapes, k2_shapes, t, c = [], [], frames, 1536
    for u in rates:
        t, c = t * u, c // 2
        (k1_shapes if c > 128 else k2_shapes).append((b, c, t))
    return k1_shapes + [(b, 24, t)], k2_shapes


def _vs(got, ref, dt, name):
    err = (got.float() - ref.float()).abs().max().item()
    lim = TOL[dt] * max(1.0, ref.float().abs().max().item())
    if not err <= lim:
        raise AssertionError(f"{name}: err {err} > {lim}")
    return err, lim


def check_exact_edge(gen: torch.Generator) -> dict:
    """K1 and K2 in exact-edge mode against their plain versions (the exact
    route's own ops, in float32: bfloat16 inputs and weights are compared
    against the float32 route over the same values) within TOL, at every
    launch of EXACT_WORK and at EXACT_SHORT; float32 timed beside the exact
    route (cuDNN's convs in TF32, as the engine runs them), and the default
    mode's distance from the exact route reported beside."""
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    out = {"snake_cmajor": [], "resblock_cmajor": []}
    cases = [(name, *exact_launches(EXACT_RATES[voc], b, f))
             for name, voc, b, f in EXACT_WORK]
    cases.append(("short", [(2, c, t) for c, t in EXACT_SHORT],
                  [(2, c, t) for c, t in EXACT_SHORT]))
    for dt in (torch.float32, torch.bfloat16):
        timed = dt == torch.float32
        for name, k1_shapes, k2_shapes in cases:
            for b, c, t in dict.fromkeys(k1_shapes):
                x = rand(b, c, t).to(dt)
                al, be = rand(c) * 0.3, rand(c) * 0.3
                ref = k1.snake_cmajor_plain(x.float(), al, be, True,
                                            exact_edge=True)
                got = k1.snake_cmajor(x, al, be, True, exact_edge=True)
                err, lim = _vs(got, ref, dt, f"K1 exact {dt} {(b, c, t)}")
                row = {"case": name, "dtype": str(dt), "shape": [b, c, t],
                       "max_abs_err": err, "tol": lim,
                       "default_mode_err": (k1.snake_cmajor(x, al, be, True)
                                            .float() - ref).abs().max().item()}
                if timed and name != "short":
                    row["ms"] = cuda_ms(lambda: k1.snake_cmajor(
                        x, al, be, True, exact_edge=True), 10)
                    row["exact_route_ms"] = cuda_ms(
                        lambda: k1.snake_cmajor_plain(x, al, be, True,
                                                      exact_edge=True), 3)
                out["snake_cmajor"].append(row)
            for b, c, t in dict.fromkeys(k2_shapes):
                for k in (3, 7, 11):
                    rb = rand_resblock(rand, c, k)
                    w = k2.pack_resblock(rb, EngineConfig().bigvgan, dt,
                                         exact_edge=True)
                    w32 = [p.float() for p in w]
                    x = (rand(b, c, t) * 0.5).to(dt)
                    ref = k2.resblock_cmajor_plain(x.float(), *w32, k, DILS,
                                                   exact_edge=True)
                    got = k2.resblock_cmajor(x, *w, k, DILS, exact_edge=True)
                    err, lim = _vs(got, ref, dt,
                                   f"K2 exact {dt} {(b, c, t)} k={k}")
                    row = {"case": name, "dtype": str(dt), "shape": [b, c, t],
                           "k": k, "max_abs_err": err, "tol": lim,
                           "tt": k2.pick_tile(c, k, DILS, t),
                           "default_mode_err": (
                               k2.resblock_cmajor(x, *w, k, DILS).float()
                               - ref).abs().max().item()}
                    if timed and name != "short":
                        row["ms"] = cuda_ms(lambda: k2.resblock_cmajor(
                            x, *w, k, DILS, exact_edge=True), 3)
                        torch.backends.cudnn.allow_tf32 = True
                        try:
                            row["exact_route_ms"] = cuda_ms(
                                lambda: k2.resblock_cmajor_plain(
                                    x, *w, k, DILS, exact_edge=True), 2)
                        finally:
                            torch.backends.cudnn.allow_tf32 = False
                    out["resblock_cmajor"].append(row)
    return out


def run_exact_vocoder(gen: torch.Generator) -> dict:
    """The vocoder's exact work (``_vocode(..., exact=True)``) at
    EXACT_WORK's shapes, on the kernel route (K1 and K2 in exact-edge mode)
    against the plain route, float32 (TF32 off), within VOCODER_TOL: the
    ×1024 BigVGAN with a speaker input and the ×256 mel vocoder, full
    width, random weights. Each timed on both routes as the engine runs
    them (cuDNN in TF32), host-synchronised, beside its K1/K2 launches."""
    out = {}
    vocs = {}
    for voc_name, cfg in (("indextts", EngineConfig().bigvgan),
                          ("f5", MelVocoderConfig())):
        p = weights.init_bigvgan(weights.Init(gen, "cuda"), cfg)
        spk = (torch.randn(1, 1, cfg.speaker_embedding_dim, generator=gen,
                           device="cuda") * 0.1
               if cfg.speaker_conditioned else None)
        vocs[voc_name] = (voc_mod.WindowedVocoder(p, cfg),
                          voc_mod.WindowedVocoder(p, cfg, use_pallas=False,
                                                  fuse_resblocks=False,
                                                  edge_exact=True), cfg, spk)
    for name, voc_name, b, frames in EXACT_WORK:
        fast, plain, cfg, spk = vocs[voc_name]
        x = torch.randn(b, frames, cfg.gpt_dim, generator=gen,
                        device="cuda") * 0.5
        zero_counts()
        got = fast._vocode(x, spk, exact=True)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        want = plain._vocode(x, spk, exact=True)
        err = float((got.float() - want.float()).abs().max())
        if not (err <= VOCODER_TOL and counts.get("snake_cmajor")
                and counts.get("resblock_cmajor")):
            raise AssertionError(f"exact vocoder {name}: err {err}, "
                                 f"launches {counts}")
        torch.backends.cudnn.allow_tf32 = True
        try:
            ms = _wall_ms(lambda: fast._vocode(x, spk, exact=True), 5)
            route_ms = _wall_ms(lambda: plain._vocode(x, spk, exact=True), 3)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        out[name] = {"batch": b, "frames": frames, "max_abs_err": err,
                     "launches": counts, "kernels_ms": ms,
                     "exact_route_ms": route_ms}
    del vocs
    gc.collect()
    torch.cuda.empty_cache()
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


def check_anc_attention(gen: torch.Generator) -> list:
    """K3 against its plain version at ANC_SHAPES (module docstring, phase
    kernels/anc-attention). Row r of a shape pads its first 5·(r + 1)
    prefix keys."""
    dev, nb, rows = "cuda", 3, []
    for cell, (b, h, d, s0, g_len) in ANC_SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            r = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(dt)
            qkv = 1.5 * r(b * nb, 3 * h * d)
            kp, vp = r(b, h, s0, d), r(b, h, s0, d)
            kg, vg = r(b, h, nb, g_len, d), r(b, h, nb, g_len, d)
            keep = torch.ones((b, s0), dtype=torch.bool, device=dev)
            for row in range(b):
                keep[row, :5 * (row + 1) % s0] = False
            amap = torch.randint(0, nb, (b, nb, g_len), generator=gen,
                                 device=dev)
            for slot in (0, g_len // 2, g_len - 2, g_len - 1):
                at = torch.tensor(slot, device=dev)
                kg2, vg2 = kg.clone(), vg.clone()
                got = k3.anc_attention(qkv, kp, vp, kg, vg, at, keep, amap,
                                       nb)
                want = k3.anc_attention_plain(qkv, kp, vp, kg2, vg2, at,
                                              keep, amap, nb)
                torch.cuda.synchronize()
                if not (torch.equal(kg, kg2) and torch.equal(vg, vg2)):
                    raise AssertionError(f"K3 {cell} {dt} slot {slot}: the "
                                         "written K/V slot differs")
                err = (got.float() - want.float()).abs().max().item()
                top = want.float().abs().max().item()
                if err > ANC_TOL[dt] * top:
                    raise AssertionError(f"K3 {cell} {dt} slot {slot}: "
                                         f"{err} > {ANC_TOL[dt]} * {top}")
                es = qkv.element_size()
                # each live K/V row read once: the kept prefix once a
                # (row, head), the distinct ancestors' rows of each gen
                # slot < slot; qkv read, the slot's k/v and o written
                am = amap.cpu().numpy()
                anc = sum(len(set(am[i, :, s]))
                          for i in range(b) for s in range(slot))
                live = int(keep.sum()) + anc
                nbytes = es * h * d * (2 * live + 6 * b * nb)
                # the yardstick: one PyTorch attention over each beam's
                # gathered keys (prefix, ancestors, the slot), padded
                # prefix keys masked
                beams = torch.arange(nb, device=dev)
                src = amap[:, :, :slot + 1].clone()
                src[:, :, slot] = beams
                idx = src[:, None, :, :, None].expand(b, h, nb, slot + 1, d)

                def gathered(pc, gc):
                    pre = pc[:, :, None].expand(b, h, nb, s0, d)
                    seq = torch.cat([pre, torch.gather(gc, 2, idx)], 3)
                    return seq.transpose(1, 2).reshape(b * nb, h,
                                                       s0 + slot + 1, d)
                kk, vv = gathered(kp, kg), gathered(vp, vg)
                q = qkv[:, :h * d].reshape(b * nb, h, 1, d)
                mask = torch.cat([keep.repeat_interleave(nb, 0),
                                  torch.ones((b * nb, slot + 1),
                                             dtype=torch.bool, device=dev)],
                                 1)[:, None, None, :]
                rows.append({
                    "cell": cell, "dtype": str(dt), "B": b, "H": h, "D": d,
                    "S0": s0, "G": g_len, "slot": slot,
                    "split": k3.split_of(b, h, k3.resident_ctas(
                        torch.device(dev), dt, d)),
                    "max_abs_err": err, "live_bytes": nbytes,
                    "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                    "ms": cuda_ms(lambda: k3.anc_attention(
                        qkv, kp, vp, kg, vg, at, keep, amap, nb), 50),
                    "plain_ms": cuda_ms(lambda: k3.anc_attention_plain(
                        qkv, kp, vp, kg2, vg2, at, keep, amap, nb), 50),
                    "library_ms": cuda_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, kk, vv, attn_mask=mask), 50)})
    return rows


def summarize_anc(rows, launches: int) -> dict:
    """The kernels-line entry of K3: the line's bfloat16 case at the last
    slot, every case under "cases"."""
    top = next(r for r in rows if r["cell"] == "line"
               and r["dtype"] == "torch.bfloat16"
               and r["slot"] == r["G"] - 2)
    return {"name": "anc_attention", "route": "cuda",
            "source": "index_tts_dubbing_tpu_torch/csrc/anc_attention.cu",
            "replaces": None, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "library_ms")},
            "bound_by": "bytes",
            "per": "one launch (one layer) at the line's bfloat16 shape, "
                   "slot G - 2; library: scaled_dot_product_attention over "
                   "the gathered keys, the gather not timed",
            "launches_note": "launches: the default beam path (three "
                             "requests); every path in launches_by_path",
            "cases": rows}


def check_step_norm(gen: torch.Generator) -> list:
    """K4's entries against their plain versions at STEP_NORM_SHAPES
    (module docstring, phase kernels/step-norm)."""
    dev, rows = "cuda", []
    for cell, (r, c, dt) in STEP_NORM_SHAPES.items():
        rand = lambda *sh, s=1.0: (s * torch.randn(sh, generator=gen,
                                                   device=dev)).to(dt)
        rtol, atol = STEP_NORM_TOL[dt]
        x, y, h = rand(r, c, s=3.0), rand(r, c), rand(r, 4 * c, s=3.0)
        bias, hb = rand(c, s=0.5), rand(4 * c)
        p = {"g": 1.0 + rand(c, s=0.1), "b": rand(c, s=0.1)}
        es = x.element_size()
        cases = (
            # x, y, bias, g, b read; y and LN written
            ("add_layer_norm", es * (4 * r * c + 3 * c),
             lambda y: k4.add_layer_norm(x, y, bias, p),
             lambda y: k4.add_layer_norm_plain(x, y, bias, p), y),
            # h and its bias read, h written
            ("bias_gelu", es * (2 * r * 4 * c + 4 * c),
             lambda h: (h, k4.bias_gelu(h, hb)),
             lambda h: (h, k4.bias_gelu_plain(h, hb, False)), h))
        for name, nbytes, run, plain, arg in cases:
            got_res, got = run(arg.clone())
            want_res, want = plain(arg.clone())
            torch.cuda.synchronize()
            if name == "add_layer_norm" and not torch.equal(got_res, want_res):
                raise AssertionError(f"K4 {name} {cell}: the residual differs")
            err = (got.float() - want.float()).abs()
            if (err > rtol * want.float().abs() + atol).any():
                raise AssertionError(f"K4 {name} {cell}: max error "
                                     f"{err.max().item()}")
            # the replays write over one copy of y or h again and again
            buf = arg.clone()
            rows.append({"entry": name, "cell": cell, "rows": r,
                         "C": c if name == "add_layer_norm" else 4 * c,
                         "dtype": str(dt),
                         "max_abs_err": err.max().item(), "bytes": nbytes,
                         "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                         "ms": cuda_ms(lambda: run(buf), 50),
                         "plain_ms": cuda_ms(lambda: plain(buf), 50)})
    return rows


def summarize_step_norm(rows, launches: int) -> dict:
    """The kernels-line entry of K4: the line's bfloat16 add_layer_norm,
    every case under "cases"."""
    top = next(r for r in rows if r["cell"] == "line-bf16"
               and r["entry"] == "add_layer_norm")
    return {"name": "step_norm", "route": "cuda",
            "source": "index_tts_dubbing_tpu_torch/csrc/step_norm.cu",
            "replaces": None, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms")},
            "library_ms": None, "bound_by": "bytes",
            "per": "one add_layer_norm launch (y and bias) at the line's "
                   "bfloat16 shape",
            "launches_note": "launches: add_layer_norm + bias_gelu on the "
                             "default beam path (three requests); every path "
                             "in launches_by_path",
            "cases": rows}


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
           "anc_attention": k3.anc_attention,
           "add_layer_norm": k4.add_layer_norm, "bias_gelu": k4.bias_gelu,
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
        lat.to(tts.vocoder.compute_dtype), spk, use_pallas=False,
        fuse_resblocks=False)[0]
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


def run_path(tts: IndexTTS, call, need=("snake_cmajor", "resblock_cmajor")):
    """One request of the engine with every launch count set to 0 just
    before it: (its output, the counts, a report). Every kernel in ``need``
    (K1 and K2 by default) must launch."""
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if min(counts[name] for name in need) < 1:
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


def run_indextts2(tmp: Path):
    """IndexTTS-2 at published widths in bf16 (random weights, seed 0): one
    ``infer_batch`` of four lines (six segments: TEXTS[2] is three) at cap
    120 under a CPU profiler, so every
    decode step's span says its K3 and K4 launches. Requires every step's
    ``anc_attn`` at the trunk's 24 layers and ``step_norm`` at 3 × 24 + 1,
    K1 and K2 launched by the mel
    vocoder's per-line plan, and each line's int16 wav at 22 050 Hz of its
    segments' frames, finite and not constant."""
    from index_tts_dubbing_tpu_torch.engine.indextts2 import IndexTTS2
    t0 = time.perf_counter()
    tts = IndexTTS2(is_fp16=True, seed=0, verbose_init=False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = str(tmp / "prompt22.wav")
    tt = np.arange(3 * 22050) / 22050.0
    wav = (0.3 * np.sin(2 * np.pi * 160.0 * tt) * np.sin(2 * np.pi * 3.0 * tt)
           + 0.05 * np.random.default_rng(2).standard_normal(tt.size))
    write_wav(prompt, wav.astype(np.float32)[None], 22050)
    texts = TEXTS[:3] + [TEXTS[0]]
    tts.infer_batch(prompt, texts, seed=1, max_mel_tokens=40)   # warm-up
    zero_counts()
    profiling.clear()
    t1 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        outs = tts.infer_batch(prompt, texts, seed=1, max_mel_tokens=120)
    wall = time.perf_counter() - t1
    counts = read_counts()
    (spans,) = profiling.requests()
    steps = [s.attrs for s in spans if s.name == "decode.step"]
    if not steps or any(a["anc_attn"] != 24 for a in steps):
        raise AssertionError(f"indextts2: decode steps' anc_attn "
                             f"{sorted({a['anc_attn'] for a in steps})}, "
                             f"want 24")
    if any(a["step_norm"] != 3 * 24 + 1 for a in steps):
        raise AssertionError(f"indextts2: decode steps' step_norm "
                             f"{sorted({a['step_norm'] for a in steps})}, "
                             f"want {3 * 24 + 1}")
    if not (counts["snake_cmajor"] and counts["resblock_cmajor"]):
        raise AssertionError(f"indextts2: K1/K2 launches {counts}")
    tp = tts.last_prompt_frames
    coded = [line for line, c in zip(tts.last_rows, tts.last_codes) if c.size]
    for i, (sr, w) in enumerate(outs):
        want = sum(f - tp for f, line in zip(tts.last_frames, coded)
                   if line == i) * tts.vocoder.upsample
        if sr != 22050 or w.dtype != np.int16 or w.shape != (want, 1):
            raise AssertionError(f"indextts2 line {i}: {sr} Hz {w.dtype} "
                                 f"{w.shape}, want ({want}, 1)")
        if w.min() == w.max():
            raise AssertionError(f"indextts2 line {i}: constant wav")
    check_finite("indextts2", tts.last_mel.cpu().numpy())
    lt = tts.last_times
    report = {"init_s": round(init_s, 2), "wall_s": round(wall, 3),
              "lines": len(outs), "steps": lt.decode_steps,
              "graph_steps": sum(a["graph"] for a in steps),
              "anc_attn": 24, "step_norm": 3 * 24 + 1, "gpt_gen_s": round(lt.gpt_gen, 3),
              "s2m_s": round(lt.s2m, 3), "bigvgan_s": round(lt.bigvgan, 3),
              "frames": tts.last_frames,
              "launches": {k: counts[k] for k in ("snake_cmajor",
                                                  "resblock_cmajor",
                                                  "anc_attention",
                                                  "add_layer_norm",
                                                  "bias_gelu")}}
    del tts
    gc.collect()
    torch.cuda.empty_cache()
    return counts, report


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
        use_pallas=False, fuse_resblocks=False)[0].cpu().numpy()
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


# slice 9: the cap of the float32 beam search that decodes codes for the
# latent pass
LATENT_CAP = 64
# the dvae card-vs-CPU decode and the sinc conv: float32 convs of up to
# 1024 channels in another summation order, relative to max|CPU|
DVAE_TOL = 1e-4


def _wall_ms(fn, reps: int = 3) -> float:
    """Host milliseconds of one synchronised ``fn()`` after a warm-up, the
    mean of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def sampling_wav(tts: IndexTTS, prompt: str) -> np.ndarray:
    """The float32 wav of one sampling request (TEXTS[1] at cap 300) for
    the phases that need an engine wav: the speaker similarity and the
    vocoder's training losses. Above ``FUSED_FULL_VOCODE_MAX_STEPS`` (256)
    the fused route streams the latents and keeps that wav on the host
    (``last_wav``); at or below it the wav stays on the device."""
    tts.infer_fast(prompt, TEXTS[1], num_beams=1, max_mel_tokens=300)
    wav = np.asarray(tts.last_wav, np.float32)
    if wav.size < VOCODER_TRAIN_SAMPLES or not np.isfinite(wav).all():
        raise AssertionError(f"sampling wav: {wav.size} samples, finite "
                             f"{bool(np.isfinite(wav).all())}")
    return wav


def run_dvae_eval(tts: IndexTTS, prompt: str, wav: np.ndarray):
    """dvae at DVAEConfig() with random weights from seed 0 on the
    prompt's mel (cut to a multiple of 4 frames): the card's codes equal
    the CPU's, the decoded mel within DVAE_TOL; sinc_conv.forward (80
    filters of 251 taps, 16 kHz) on the card against the CPU on a second of
    the prompt; speaker_similarity of the prompt and a sampling request's
    wav on the engine's ECAPA, in [-1, 1]; forward_latent against
    forward_latent_bucketed in float32 on one sentence of TEXTS[2] and
    codes decoded for it (float32 beam search, cap 64)."""
    cfg = dvae.DVAEConfig()
    cpu = dvae.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = weights.from_jax_params(cpu, "cuda")
    mel = tts._cond_mel(prompt).transpose(1, 2).float()
    mel = mel[:, : mel.shape[1] // 4 * 4]
    t0 = time.perf_counter()
    codes = dvae.get_codebook_indices(card, cfg, mel)
    dec = dvae.decode(card, cfg, codes)
    torch.cuda.synchronize()
    dvae_ms = 1e3 * (time.perf_counter() - t0)
    codes_cpu = dvae.get_codebook_indices(cpu, cfg, mel.cpu())
    if not torch.equal(codes.cpu(), codes_cpu):
        raise AssertionError(f"dvae: card codes differ from the CPU's on "
                             f"{int((codes.cpu() != codes_cpu).sum())} of "
                             f"{codes_cpu.numel()}")
    dec_cpu = dvae.decode(cpu, cfg, codes_cpu)
    dvae_err = float((dec.cpu() - dec_cpu).abs().max())
    dvae_lim = DVAE_TOL * max(1.0, float(dec_cpu.abs().max()))
    if not dvae_err <= dvae_lim:
        raise AssertionError(f"dvae decode: {dvae_err} > {dvae_lim}")
    sp = sinc_conv.init(80, 251, 16000, device="cpu")
    x16 = torch.from_numpy(load_audio(prompt, 16000)[0, :16000])
    sinc_cpu = sinc_conv.forward(sp, x16[None], 251)
    sinc_card = sinc_conv.forward({k: v.cuda() for k, v in sp.items()},
                                  x16[None].cuda(), 251)
    sinc_err = float((sinc_card.cpu() - sinc_cpu).abs().max())
    sinc_lim = DVAE_TOL * max(1.0, float(sinc_cpu.abs().max()))
    if sinc_card.shape != (1, 16000, 80) or not sinc_err <= sinc_lim:
        raise AssertionError(f"sinc_conv {tuple(sinc_card.shape)}: "
                             f"{sinc_err} > {sinc_lim}")
    ecapa32 = weights.cast_floating(tts.params["bigvgan"]["speaker_encoder"],
                                    torch.float32)
    embed = speaker_sim.make_ecapa_embedder(ecapa32)
    sim = speaker_sim.speaker_similarity(load_audio(prompt, 24000)[0], 24000,
                                         wav, 24000, embed)
    if not (np.isfinite(sim) and -1.0 <= sim <= 1.0):
        raise AssertionError(f"speaker_similarity {sim}")
    # forward_latent on a real sentence and its decoded codes
    params = weights.cast_floating(tts.params["gpt"], torch.float32)
    gcfg = tts.gpt_cfg
    ids = tts.sentence_rows(TEXTS[2])[0]
    row = torch.as_tensor(ids, dtype=torch.long, device="cuda")[None]
    conds = tts._conditioning(tts._cond_mel(prompt)).float()
    x = tts.fused_batch([ids])
    emb, keep = decode_mod.build_prefix_emb(params, gcfg, conds, x["ids"],
                                            x["pos"], x["seg"], x["cond_idx"])
    res = decode_mod._beam_decode(
        params, gcfg, replace(tts._sampling_config({}), do_sample=False,
                              max_mel_tokens=LATENT_CAP),
        emb, keep, None, 3, 0.0, stochastic=False, live=x["live"])
    n_codes = int(res.lengths[0])
    codes_row = res.codes[:1, :n_codes]
    lens = lambda n: torch.tensor([n], device="cuda")
    args = (params, gcfg, conds, row, lens(row.shape[1]), codes_row,
            lens(n_codes))
    lat = gpt_model.forward_latent(*args)
    lat_b = gpt_model.forward_latent_bucketed(*args)
    lat_err = float((lat - lat_b).abs().max())
    lat_lim = DVAE_TOL * max(1.0, float(lat_b.abs().max()))
    if lat.shape != (1, n_codes, gcfg.model_dim) or not lat_err <= lat_lim:
        raise AssertionError(f"forward_latent {tuple(lat.shape)} vs bucketed: "
                             f"{lat_err} > {lat_lim}")
    del params, emb
    gc.collect()
    torch.cuda.empty_cache()
    return read_counts(), {
        "dvae": {"mel_frames": mel.shape[1], "codes": codes.shape[1],
                 "codes_equal_cpu": True, "decode_err": dvae_err,
                 "decode_tol": dvae_lim, "card_ms": dvae_ms},
        "sinc_conv": {"err": sinc_err, "tol": sinc_lim},
        "speaker_similarity": sim,
        "forward_latent": {"codes": n_codes, "vs_bucketed": lat_err,
                           "tol": lat_lim}}


# --- slice 10: the mesh and training ---------------------------------------

MESH_CAP = 80               # mesh/serve: the beam-sampling request's cap
MESH_GREEDY_CAP = 64
MESH_RANK_TIMEOUT = 420     # s a rank may take, its engine's build included
TRAIN_STEPS = 5
TRAIN_BATCH = 4
TRAIN_MEL_FRAMES = 3 * 24000 // 256     # a 3 s conditioning mel
TRAIN_TEXT, TRAIN_CODES = 64, 200
TRAIN_TOL = 5e-5            # small config, card vs CPU, after 2 AdamW steps
VOCODER_TRAIN_SAMPLES = 36000           # 1.5 s at 24 kHz
LOSS_RTOL = 1e-3            # vocoder totals, card vs CPU (float32, no TF32)


def first_difference(p32, cfg, sc, emb, keep, ref, got, ref_len, got_len,
                     name: str):
    """None when a greedy row equals ``generate``'s; else the first step
    where they part, which must be a near-tie of ``generate``'s logits
    (top-2 gap under GAP_TOL relative)."""
    n = min(ref_len, got_len)
    diff = np.nonzero(got[:n] != ref[:n])[0]
    if ref_len == got_len and not diff.size:
        return None
    step = int(diff[0]) if diff.size else n
    top = torch.topk(processed_logits_at(p32, cfg, sc, emb, keep, ref, step),
                     2).values
    gap = float((top[0] - top[1]) / top[0].abs().clamp_min(1e-30))
    if not gap < GAP_TOL:
        raise AssertionError(f"{name} differs from one process at step "
                             f"{step}, top-2 gap {gap}")
    return {"step": step, "gap": gap}


def mesh_rows(tts: IndexTTS) -> list:
    """Four sentence rows: TEXTS[2]'s three and TEXTS[1]."""
    return tts.sentence_rows(TEXTS[2]) + tts.sentence_rows(TEXTS[1])


def mesh_worker(rank: int, port: int, inputs: str, out: str) -> int:
    """One rank of mesh/serve (``chip_smoke.py --mesh-rank``): gloo over
    TCP on 127.0.0.1, CUDA tensors on the one card. (data 1, model 2): the
    full-width bf16 engine serves one infer_fast with the reference's
    defaults (beam sampling) and times its beam decode; float32 greedy
    ``generate`` on the parent's prefix at (1, 2) and at (2, 1). Writes its
    wav, launch counts, codes and times to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = mesh_lib.init_distributed(f"127.0.0.1:{port}", 2, rank,
                                        backend="gloo")
    cuda_lib.load()
    z = np.load(inputs)
    mesh12 = mesh_lib.make_mesh(1, 2)
    t0 = time.perf_counter()
    eng = IndexTTS(is_fp16=True, seed=0, verbose_init=False, mesh=mesh12)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = str(z["prompt"])
    (sr, wav), counts, rep = run_path(eng, lambda: eng.infer_fast(
        prompt, TEXTS[2], max_mel_tokens=MESH_CAP))
    expect("mesh/serve", eng, "staged")
    check_audio("mesh/serve", sr, wav, np.sum(eng.last_sentence_frames),
                eng.vocoder.upsample)
    check_finite("mesh/serve", eng.last_wav)
    res = {"wav": wav, "init_s": init_s, "backend": backend,
           "report": json.dumps(rep), "counts": json.dumps(counts)}

    # the beam decode alone, the parent's rows and noise seed
    conds = eng._conditioning(eng._cond_mel(prompt))
    sc = eng._sampling_config(dict(max_mel_tokens=MESH_CAP))
    rows = [z[f"row{i}"] for i in range(int(z["n_rows"]))]
    eng._generator.manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes, _ = eng._decode_batch(conds, rows[:1], sc)
    torch.cuda.synchronize()
    res["beam_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / MESH_CAP

    # float32 greedy at (1, 2) and (2, 1) on the parent's prefix
    gen = torch.Generator("cuda").manual_seed(0)
    full = weights.cast_floating(weights.from_jax_params(
        weights.init(eng.cfg, gen, "cuda")["gpt"], "cuda", torch.bfloat16),
        torch.float32)
    emb = torch.as_tensor(z["emb"], device="cuda")
    keep = torch.as_tensor(z["keep"], device="cuda")
    gsc = decode_mod.SamplingConfig(do_sample=False,
                                    max_mel_tokens=MESH_GREEDY_CAP)
    specs = mesh_lib.gpt_param_specs(full, 2)
    for name, mesh, p in (("12", mesh12, mesh_lib.shard_tree(full, specs,
                                                               mesh12)),
                          ("21", mesh_lib.make_mesh(2, 1), full)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = decode_mod.generate(p, eng.gpt_cfg, gsc, emb, keep, mesh=mesh)
        torch.cuda.synchronize()
        res[f"greedy{name}_ms_per_step"] = (1e3 * (time.perf_counter() - t0)
                                            / g.steps)
        res[f"greedy{name}_codes"] = g.codes.cpu().numpy()
        res[f"greedy{name}_lens"] = g.lengths.cpu().numpy()
    np.savez(out, **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def run_mesh_serve(tts: IndexTTS, prompt: str, tmp: Path):
    """mesh/serve: two ranks of ``mesh_worker`` on the one card (NCCL refuses
    two ranks on one device, so gloo, with CUDA tensors); the kernels were
    built by this process first, so the ranks load them and do not race the
    build. Each rank's wav is checked (int16 at 24 kHz, finite, not
    constant, its sentences' frames) and the two must be equal; K1, K2 and
    K4's two entries launch on each rank and B4 on none. Float32 greedy
    codes at (1, 2) and (2, 1) against this process's ``generate`` on the
    same prefix: equal, or parting first at a near-tie under GAP_TOL. ms a
    step of each beside one process."""
    cfg = tts.gpt_cfg
    rows = mesh_rows(tts)
    p32 = weights.cast_floating(tts.params["gpt"], torch.float32)
    c32 = tts._conditioning(tts._cond_mel(prompt)).float()
    pad_to = next(b for b in tts.TEXT_BUCKETS if b >= max(r.size for r in rows))
    pre = decode_mod.prepare_prefix_host(cfg, rows, pad_to=pad_to)
    t = lambda k: torch.as_tensor(pre[k].astype(np.int64), device="cuda")
    emb, keep = decode_mod.build_prefix_emb(p32, cfg, c32, t("ids"), t("pos"),
                                            t("seg"), t("cond_idx"))
    inputs = tmp / "mesh_inputs.npz"
    np.savez(inputs, prompt=prompt, emb=emb.cpu().numpy(),
             keep=keep.cpu().numpy(), n_rows=len(rows),
             **{f"row{i}": r for i, r in enumerate(rows)})
    # one process first, alone on the card: the beam decode and float32
    # greedy
    sc = tts._sampling_config(dict(max_mel_tokens=MESH_CAP))
    conds = tts._conditioning(tts._cond_mel(prompt))
    tts._generator.manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tts._decode_batch(conds, rows[:1], sc)
    torch.cuda.synchronize()
    one = {"beam_ms_per_step": 1e3 * (time.perf_counter() - t0) / MESH_CAP}
    gsc = decode_mod.SamplingConfig(do_sample=False,
                                    max_mel_tokens=MESH_GREEDY_CAP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = decode_mod.generate(p32, cfg, gsc, emb, keep)
    torch.cuda.synchronize()
    one["greedy_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / ref.steps
    ref_codes, ref_lens = ref.codes.cpu().numpy(), ref.lengths.cpu().numpy()

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = [open(tmp / f"mesh_rank{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
         str(r), "--mesh-port",
         str(port), "--mesh-inputs", str(inputs), "--mesh-out",
         str(tmp / f"mesh_rank{r}.npz")], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(2)]

    deadline = time.perf_counter() + MESH_RANK_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        raise AssertionError("mesh/serve: a rank passed its timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.seek(0)
            text = f.read()
            f.close()
            print(text.rstrip()[-3000:], flush=True)
    if any(p.returncode for p in procs):
        raise AssertionError("mesh/serve: rank exit codes "
                             f"{[p.returncode for p in procs]}")
    got = [np.load(tmp / f"mesh_rank{r}.npz") for r in range(2)]
    if not np.array_equal(got[0]["wav"], got[1]["wav"]):
        raise AssertionError("mesh/serve: the two ranks' wavs differ")
    counts = [json.loads(str(g["counts"])) for g in got]
    for r, c in enumerate(counts):
        if min(c["snake_cmajor"], c["resblock_cmajor"], c["add_layer_norm"],
               c["bias_gelu"]) < 1 or c["copy_on_fork"]:
            raise AssertionError(f"mesh/serve rank {r}: launches {c}")
    out = {"backend": str(got[0]["backend"]),
           "ranks": [json.loads(str(g["report"])) for g in got],
           "init_s": [float(g["init_s"]) for g in got],
           "wav_samples": int(got[0]["wav"].shape[0]),
           "beam_ms_per_step": {"one_process": one["beam_ms_per_step"],
                                "mesh_1x2": [float(g["beam_ms_per_step"])
                                             for g in got]},
           "greedy_ms_per_step": {"one_process": one["greedy_ms_per_step"]}}
    for name in ("12", "21"):
        out["greedy_ms_per_step"][f"mesh_{name[0]}x{name[1]}"] = [
            float(g[f"greedy{name}_ms_per_step"]) for g in got]
        for r, g in enumerate(got):
            codes, lens = g[f"greedy{name}_codes"], g[f"greedy{name}_lens"]
            ties = [first_difference(p32, cfg, gsc, emb[i:i + 1],
                                     keep[i:i + 1], ref_codes[i], codes[i],
                                     int(ref_lens[i]), int(lens[i]),
                                     f"mesh/serve ({name}) rank {r} row {i}")
                    for i in range(len(rows))]
            out[f"greedy_{name[0]}x{name[1]}_rank{r}"] = {
                "equal_rows": sum(x is None for x in ties),
                "ties": [x for x in ties if x]}
    del p32
    # rank 0's counts stand for the path; every rank's are checked above
    return counts[0], dict(out, launches=counts)


def run_train_gpt():
    """train/gpt: five ``train_step``s of the full-width GPT in float32 on
    the card (batch 4: a 3 s mel, 64 text tokens, 200 codes; lr 1e-3,
    warmup 1): finite losses, the last below the first; ms a step and the
    peak memory. Then the small config's two steps on the card against the
    CPU's from the same weights: losses within 1e-4 relative, every
    parameter within TRAIN_TOL."""
    cfg = EngineConfig().gpt
    gen = torch.Generator("cuda").manual_seed(0)
    b = TRAIN_BATCH
    batch = {
        "cond_mel": torch.randn((b, TRAIN_MEL_FRAMES, 100), generator=gen,
                                device="cuda"),
        "cond_lens": torch.full((b,), TRAIN_MEL_FRAMES, device="cuda"),
        "text_ids": torch.randint(2, cfg.number_text_tokens,
                                  (b, TRAIN_TEXT), generator=gen,
                                  device="cuda"),
        "text_lens": torch.tensor([64, 60, 48, 40], device="cuda"),
        "codes": torch.randint(0, 8192, (b, TRAIN_CODES), generator=gen,
                               device="cuda"),
        "code_lens": torch.tensor([200, 180, 150, 120], device="cuda")}
    tx = train_mod.make_optimizer(lr=1e-3, warmup=1)
    state = train_mod.init_state(
        weights.init_gpt(weights.Init(gen, "cuda"), cfg), tx)
    n_params = sum(p.numel() for p in weights.jax_leaves(state.params))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_mod.train_step(state, batch, cfg, tx)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train/gpt losses {losses}")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()

    scfg = replace(cfg, **SMALL_GPT)
    cpu_gen = torch.Generator().manual_seed(1)
    small = weights.init_gpt(weights.Init(cpu_gen, "cpu"), scfg)
    sb = {"cond_mel": torch.randn((2, 40, 100), generator=cpu_gen),
          "cond_lens": torch.tensor([40, 32]),
          "text_ids": torch.randint(2, 120, (2, 10), generator=cpu_gen),
          "text_lens": torch.tensor([10, 7]),
          "codes": torch.randint(0, 8192, (2, 12), generator=cpu_gen),
          "code_lens": torch.tensor([10, 6])}
    runs = {}
    for dev in ("cpu", "cuda"):
        st = train_mod.init_state(
            weights.from_jax_params(small, dev), tx)
        ls = []
        for _ in range(2):
            st, m = train_mod.train_step(
                st, {k: v.to(dev) for k, v in sb.items()}, scfg, tx)
            ls.append(float(m["loss"]))
        runs[dev] = (ls, [p.detach().cpu() for p in
                          weights.jax_leaves(st.params)])
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    worst = max(float((a - c).abs().max())
                for a, c in zip(runs["cuda"][1], runs["cpu"][1]))
    if not worst <= TRAIN_TOL:
        raise AssertionError(f"train/gpt small: card vs CPU {worst}")
    return {"params": n_params, "batch": b, "mel_frames": TRAIN_MEL_FRAMES,
            "text": TRAIN_TEXT, "codes": TRAIN_CODES, "losses": losses,
            "grad_norms": norms, "ms_per_step": ms,
            "max_memory_allocated": peak,
            "small_card_vs_cpu": {"losses_card": runs["cuda"][0],
                                  "losses_cpu": runs["cpu"][0],
                                  "max_param_diff": worst}}


def run_train_vocoder(wav: np.ndarray):
    """train/vocoder: the generator's and the discriminators' totals with
    backward on 1.5 s of an engine wav (the generated wav: the same plus
    noise), the discriminators random from a seed: finite losses and
    gradients, ms each; the generator total on the card within LOSS_RTOL
    of the CPU's on the first 0.25 s."""
    gen = torch.Generator("cuda").manual_seed(2)
    real = torch.as_tensor(wav[:VOCODER_TRAIN_SAMPLES], device="cuda")[None]
    if real.shape[1] != VOCODER_TRAIN_SAMPLES:
        raise AssertionError(f"train/vocoder: {real.shape[1]} samples")
    fake = (real + 0.05 * torch.randn(real.shape, generator=gen,
                                      device="cuda")).requires_grad_(True)
    mpd = disc.init_mpd(gen, "cuda")
    mrd = disc.init_mrd(gen, "cuda")
    dparams = weights.jax_leaves(mpd) + weights.jax_leaves(mrd)
    for p in dparams:
        p.requires_grad_(True)
    banks = vl.make_mel_banks(device="cuda")
    out = {}
    for name in ("generator", "discriminator"):
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "generator":
                total, terms = vl.generator_total_loss(mpd, mrd, banks, real,
                                                       fake)
                grads = torch.autograd.grad(total, [fake] + dparams)
            else:
                total, terms = vl.discriminator_total_loss(mpd, mrd, real,
                                                           fake)
                grads = torch.autograd.grad(total, dparams)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        if not (torch.isfinite(total) and all(torch.isfinite(g).all()
                                              for g in grads)):
            raise AssertionError(f"train/vocoder {name}: not finite")
        out[name] = {"total": total.item(), "ms": ms,
                     **{k: v.item() for k, v in terms.items()}}
    n = VOCODER_TRAIN_SAMPLES // 6
    cut = lambda t, dev: t.detach()[:, :n].to(dev)
    to_cpu = lambda tree: weights.from_jax_params(
        weights.to_jax_params(tree), "cpu")
    card = vl.generator_total_loss(mpd, mrd, banks, cut(real, "cuda"),
                                   cut(fake, "cuda"))[0].item()
    host = vl.generator_total_loss(
        to_cpu(mpd), to_cpu(mrd), vl.make_mel_banks(device="cpu"),
        cut(real, "cpu"), cut(fake, "cpu"))[0].item()
    if not abs(card - host) <= LOSS_RTOL * abs(host):
        raise AssertionError(f"train/vocoder: card {card}, CPU {host}")
    out["card_vs_cpu"] = {"samples": n, "card": card, "cpu": host}
    return out


# slice11: the vocoder's switches (use_pallas, fuse_resblocks, edge_exact)
SWITCHES = [(True, True, True), (True, False, True), (False, True, True),
            (True, True, False)]
# (K1, K2) launches per window batch at full width by (use_pallas,
# fuse_resblocks): K1 on every activation outside a fused resblock
PER_BATCH = {(True, True): (55, 9), (True, False): (109, 0),
             (False, True): (0, 9)}
# full-width conformer input layers and classifier head, card vs CPU in
# float32 (no TF32): |card - cpu| <= HEADS_TOL * max(1, max|cpu|)
HEADS_TOL = 1e-4
CONV_STACKS = {"conv2d_subsample3": [("conv", 5, 3)],
               "conv2d_subsample4": [("conv0", 3, 2), ("conv1", 3, 2)],
               "conv2d_subsample6": [("conv0", 3, 2), ("conv1", 5, 3)],
               "conv2d_subsample8": [("conv0", 3, 2), ("conv1", 3, 2),
                                     ("conv2", 3, 2)]}


def label(setting) -> str:
    """"TFT" for (use_pallas, fuse_resblocks, edge_exact) = (1, 0, 1)."""
    return "".join("TF"[not flag] for flag in setting)


def switched(tts: IndexTTS, setting, params=None, dtype=None):
    use_pallas, fuse_resblocks, edge_exact = setting
    return voc_mod.WindowedVocoder(
        params if params is not None else tts.params["bigvgan"],
        tts.bigvgan_cfg, compute_dtype=dtype or tts.dtype,
        use_pallas=use_pallas, fuse_resblocks=fuse_resblocks,
        edge_exact=edge_exact)


def run_switches(tts: IndexTTS, res, spk: torch.Tensor):
    """stream_device on the multi request's first row (600 frames, two
    window batches) through a vocoder of each of SWITCHES, counted from
    zero: K1 and K2 as PER_BATCH per vocoder batch (the window batches and,
    with edge_exact, the patches' batch in exact-edge mode), nothing else.
    Each held
    to the exact route over the whole stream in one piece: within
    VOCODER_TOL at least EDGE_FRAMES from the ends, and over the whole wav
    within VOCODER_TOL with edge_exact (the ends patched), EDGE_TOL without.
    (T, T, F) equals (T, T, T) bit for bit but for the first and last
    halo·upsample samples, and differs in both."""
    frames = int(res.lens[0])
    lat = res.lat[:1, :frames]
    up = tts.vocoder.upsample
    exact = voc_mod._vocode_window_cmajor(
        tts.params["bigvgan"], tts.bigvgan_cfg, lat.to(tts.dtype), spk,
        use_pallas=False, fuse_resblocks=False)[0].float().cpu().numpy()
    paths, wavs, out = {}, {}, {}
    for setting in SWITCHES:
        name = label(setting)
        voc = switched(tts, setting)
        batches = len(list(voc._plan_batches(voc._window_list(frames))))
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        wav = voc.stream_device(lat, np.array([frames]), spk=spk)
        stream_s = time.perf_counter() - t0
        counts = read_counts()
        n1, n2 = PER_BATCH[setting[:2]]
        kb = batches + setting[2]
        want = {k: 0 for k in COUNTED}
        want.update(snake_cmajor=n1 * kb, resblock_cmajor=n2 * kb)
        if counts != want:
            raise AssertionError(f"switches {name}: launches {counts}, want "
                                 f"{want}")
        if wav.shape != (frames * up,) or not np.isfinite(wav).all():
            raise AssertionError(f"switches {name}: wav {wav.shape}")
        diff = np.abs(wav - exact)
        inner = float(diff[EDGE_FRAMES * up: (frames - EDGE_FRAMES) * up]
                      .max())
        whole = float(diff.max())
        if not (inner <= VOCODER_TOL
                and whole <= (VOCODER_TOL if setting[2] else EDGE_TOL)):
            raise AssertionError(f"switches {name} vs exact: interior "
                                 f"{inner}, whole {whole}")
        paths[f"slice11/stream/{name}"] = counts
        wavs[name] = wav
        out[name] = {"window_batches": batches, "stream_s": stream_s,
                     "launches": {k: v for k, v in counts.items() if v},
                     "vs_exact_interior": inner, "vs_exact_whole": whole}
    h = voc.halo * up
    a, b = wavs["TTF"], wavs["TTT"]
    if not np.array_equal(a[h:-h], b[h:-h]):
        raise AssertionError("switches: TTF and TTT differ away from the ends")
    ends = [float(np.abs(a[:h] - b[:h]).max()),
            float(np.abs(a[-h:] - b[-h:]).max())]
    if min(ends) == 0.0:
        raise AssertionError(f"switches: TTF equals TTT at an end {ends}")
    return paths, {"frames": frames, **out, "TTF_vs_TTT_ends": ends}


def run_fused_k1_only(tts: IndexTTS, prompt: str, spk: torch.Tensor):
    """infer_fast on the one-program flavour (TEXTS[2] at max_mel_tokens=256)
    with ``tts.vocoder`` set to (use_pallas, not fuse_resblocks,
    edge_exact): K1 109 per vocoder batch (the window batches and the
    patches' batch in exact-edge mode), K2 none; the usual int16 checks
    and the wav within VOCODER_TOL of the same vocoder's stream_device."""
    engine_voc = tts.vocoder
    voc = tts.vocoder = switched(tts, (True, False, True))
    try:
        (sr, wav), counts, rep = run_path(
            tts, lambda: tts.infer_fast(prompt, TEXTS[2], max_mel_tokens=256),
            need=("snake_cmajor",))
    finally:
        tts.vocoder = engine_voc
    expect("infer_fast-k1", tts, "fused", "fused")
    res = tts.last_fused_res
    lens = res.lens.cpu().numpy()
    windows = res.wav.numel() // (voc.window * voc.upsample)
    batches = len(list(voc._plan_batches(list(range(windows)))))
    want = {k: 0 for k in COUNTED}
    want["snake_cmajor"] = PER_BATCH[(True, False)][0] * (batches + 1)
    if counts != want:
        raise AssertionError(f"infer_fast-k1: launches {counts}, want {want}")
    t = int(res.stream_frames)
    check_audio("infer_fast-k1", sr, wav, lens.sum(), voc.upsample)
    fwav = res.wav.cpu().numpy()
    check_finite("infer_fast-k1", fwav[: t * voc.upsample])
    if not np.array_equal(res.wav_i16.cpu().numpy(), to_i16(fwav)):
        raise AssertionError("infer_fast-k1: wav_i16 is not clip(wav·32767)")
    if not np.array_equal(wav[:, 0], to_i16(fwav[: t * voc.upsample])):
        raise AssertionError("infer_fast-k1: the output is not the device's "
                             "int16")
    ref = voc.stream_device(res.lat, lens, order=np.arange(3), spk=spk)
    err = float(np.abs(fwav[: t * voc.upsample] - ref).max())
    if not err <= VOCODER_TOL:
        raise AssertionError(f"infer_fast-k1 vs stream_device: {err}")
    rep.update(rows=3, windows=windows, window_batches=batches,
               stream_frames=t, vs_stream_device=err)
    return counts, rep


def run_switch_timing(tts: IndexTTS, res, spk: torch.Tensor) -> dict:
    """Float32 ms (host, synchronised) of one window batch of 4 windows of
    the multi request's latents through each of SWITCHES and the exact
    route, on the engine's vocoder weights cast to float32; the edge
    patches' ms (two 2·halo-frame patches) beside them, on the exact route
    and on K1/K2's exact-edge mode."""
    p32 = weights.cast_floating(tts.params["bigvgan"], torch.float32)
    voc = tts.vocoder
    full = voc.window + 2 * voc.halo
    lo = np.linspace(0, int(res.lens[0]) - full, WINDOW_BATCH).astype(int)
    lat = res.lat[0].float()
    win = torch.stack([lat[s: s + full] for s in lo])
    patches = win[:2, : 2 * voc.halo]
    out = {}
    for setting in SWITCHES + [(False, False, False)]:
        v = switched(tts, setting, p32, torch.float32)
        out[f"{label(setting)}_window_batch_ms"] = _wall_ms(
            lambda: v._vocode(win, spk, exact=False), reps=5)
        if setting == SWITCHES[0]:
            out["edge_patches_kernels_ms"] = _wall_ms(
                lambda: v._vocode(patches, spk[:1], exact=True), reps=5)
    out["edge_patches_ms"] = _wall_ms(
        lambda: v._vocode(patches, spk[:1], exact=True), reps=5)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_heads() -> dict:
    """The conformer's input layers (idim 100, odim 512, 120 frames, the
    second row padded from frame 90) and ECAPA's classifier head (512 →
    1211, lin_blocks 0 and 1) on the card in float32 against the CPU, on
    weights from seed 0: within HEADS_TOL, the masks equal."""
    gen = torch.Generator().manual_seed(0)
    r = weights.Init(gen, "cpu")
    idim, odim = 100, 512
    x = torch.randn(2, 120, idim, generator=gen)
    mask = torch.ones(2, 120, dtype=torch.bool)
    mask[1, 90:] = False
    cases = {"linear_no_subsample": (
        {"out": r.linear(idim, odim), "ln": r.layer_norm(odim)}, x, mask)}
    for name, convs in CONV_STACKS.items():
        p, cin, f = {}, 1, idim
        for key, k, st in convs:
            p[key] = r.conv2d(cin, odim, k, k)
            cin, f = odim, (f - k) // st + 1
        p["out"] = r.linear(odim * f, odim)
        cases[name] = (p, x, mask)
    for blocks in (0, 1):
        cases[f"classifier_lin_blocks_{blocks}"] = (
            weights.init_ecapa_classifier(r, 512, blocks, 192, 1211),
            torch.randn(4, 1, 512, generator=gen), None)
    to_card = lambda tree: weights.from_jax_params(tree, device="cuda")
    out = {}
    for name, (p, xi, m) in cases.items():
        if m is None:
            ref = ecapa.classifier_forward(p, xi)
            got = ecapa.classifier_forward(to_card(p), xi.cuda())
        else:
            fn = getattr(conformer, name)
            ref, rmask = fn(p, xi, m)
            got, gmask = fn(to_card(p), xi.cuda(), m.cuda())
            if not torch.equal(gmask.cpu(), rmask):
                raise AssertionError(f"heads {name}: masks differ")
        torch.cuda.synchronize()
        err = (got.cpu() - ref).abs().max().item()
        lim = HEADS_TOL * max(1.0, ref.abs().max().item())
        if got.shape != ref.shape or not err <= lim:
            raise AssertionError(f"heads {name}: {tuple(got.shape)}, err "
                                 f"{err} > {lim}")
        out[name] = {"shape": list(got.shape), "max_abs_err": err}
    return out


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
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    # one rank of the mesh/serve phase, started by the phase itself
    for arg in ("--mesh-rank", "--mesh-port"):
        ap.add_argument(arg, type=int, help=argparse.SUPPRESS)
    for arg in ("--mesh-inputs", "--mesh-out"):
        ap.add_argument(arg, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_rank is not None:
        return mesh_worker(args.mesh_rank, args.mesh_port, args.mesh_inputs,
                           args.mesh_out)
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
    k1_stages = check_k1_stages(torch.Generator("cuda").manual_seed(5))
    f32 = [r for r in checks["snake_cmajor"] + k1_stages
           if r["dtype"] == "torch.float32"]
    phase("kernels/k1-stages", t1, json.dumps({
        "k1_alone_ms_per_window_batch": sum(r["ms"] * r["per_batch"]
                                            for r in f32),
        "shapes": [{k: r[k] for k in ("dtype", "C", "T", "max_abs_err", "ms",
                                      "plain_ms", "bound_ms", "lanes",
                                      "passes", "chunk")}
                   for r in k1_stages]}))
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
    exact = check_exact_edge(torch.Generator("cuda").manual_seed(6))
    phase("kernels/exact-edge", t1, json.dumps(summarize_exact(exact)))
    t1 = time.perf_counter()
    perms = check_permutes(torch.Generator("cuda").manual_seed(1))
    phase("kernels/permute", t1, "(copy_on_fork and the four gathers equal "
          f"their plain versions in {len(perms['copy_on_fork'])} + "
          f"{len(perms['gather'])} cases)")
    t1 = time.perf_counter()
    anc = check_anc_attention(torch.Generator("cuda").manual_seed(8))
    phase("kernels/anc-attention", t1, json.dumps(
        [{k: r[k] for k in ("cell", "dtype", "slot", "split", "max_abs_err",
                            "ms", "plain_ms", "bound_ms", "library_ms")}
         for r in anc]))
    t1 = time.perf_counter()
    k4_rows = check_step_norm(torch.Generator("cuda").manual_seed(9))
    phase("kernels/step-norm", t1, json.dumps(
        [{k: r[k] for k in ("entry", "cell", "max_abs_err", "ms",
                            "plain_ms", "bound_ms")}
         for r in k4_rows]))
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
        if not paths["beam"]["anc_attention"]:
            raise AssertionError("the beam path never launched K3")
        if not (paths["beam"]["add_layer_norm"] and
                paths["beam"]["bias_gelu"]):
            raise AssertionError("the beam path never launched K4")

        t1 = time.perf_counter()
        verr = check_vocoder(tts)
        phase("main/vocoder-vs-exact", t1, f"max_abs_err {verr:.3g}")

        t1 = time.perf_counter()
        phase("main/vocoder-exact-edge", t1, json.dumps(
            run_exact_vocoder(torch.Generator("cuda").manual_seed(7))))

        t1 = time.perf_counter()
        ref_report = run_vocoder_ref(tts)
        paths["vocoder-ref"] = ref_report["launches"]
        phase("main/vocoder-ref", t1, json.dumps(ref_report))
        multi = tts.last_fused_res          # slice11 vocodes its first row

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
        paths["indextts2"], report = run_indextts2(Path(tmp))
        phase("indextts2", t0, json.dumps(report))

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
        t1 = time.perf_counter()
        engine_wav = sampling_wav(tts, prompt)
        zero_counts()
        paths["slice9/dvae-eval"], report = run_dvae_eval(tts, prompt,
                                                          engine_wav)
        phase("slice9/dvae-eval", t1, json.dumps(report))
        phase("slice9", t0)

        t0 = time.perf_counter()
        t1 = time.perf_counter()
        paths["mesh/serve"], report = run_mesh_serve(tts, prompt, Path(tmp))
        phase("slice10/mesh-serve", t1, json.dumps(report))
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        phase("slice10/train-gpt", t1, json.dumps(run_train_gpt()))
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        phase("slice10/train-vocoder", t1,
              json.dumps(run_train_vocoder(engine_wav)))
        phase("slice10", t0)

        t0 = time.perf_counter()
        t1 = time.perf_counter()
        switch_paths, report = run_switches(tts, multi, spk)
        paths.update(switch_paths)
        phase("slice11/switches", t1, json.dumps(report))
        t1 = time.perf_counter()
        paths["slice11/infer_fast-k1"], report = run_fused_k1_only(
            tts, prompt, spk)
        phase("slice11/infer_fast-k1", t1, json.dumps(report))
        t1 = time.perf_counter()
        phase("slice11/window-ms", t1,
              json.dumps(run_switch_timing(tts, multi, spk)))
        t1 = time.perf_counter()
        phase("slice11/heads", t1, json.dumps(run_heads()))
        phase("slice11", t0)

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
                  "index_tts_dubbing_tpu_torch/csrc/resblock_cmajor.cuh",
                  "index_tts_dubbing_tpu/ops/pallas_resblock.py:175"),
        summarize(checks["snake_clast"], paths["vocoder-ref"]["snake_clast"],
                  "snake_clast",
                  "index_tts_dubbing_tpu_torch/csrc/snake_clast.cu",
                  "index_tts_dubbing_tpu/ops/pallas_snake.py:221"),
        summarize_permute(perms["copy_on_fork"], COF_HEADLINE,
                          sum(by_path("copy_on_fork").values()),
                          "copy_on_fork",
                          "index_tts_dubbing_tpu_torch/csrc/permute.cu",
                          f"{pallas_permute}:182",
                          launches_note="no caller on any path: only the "
                                        "kernel phase launches it"),
        summarize_permute(perms["gather"], GATHER_HEADLINE,
                          sum(gathers.values()), "permute_gen_cache",
                          "index_tts_dubbing_tpu_torch/csrc/permute.cu",
                          f"{pallas_permute}:41",
                          also_replaces=[f"{pallas_permute}:{n}"
                                         for n in (87, 266, 306)],
                          launches_note="no caller on any path: only the "
                                        "kernel phase launches it"),
    ]
    kernels.append(summarize_anc(anc, paths["beam"]["anc_attention"]))
    kernels[-1]["launches_by_path"] = by_path("anc_attention")
    k4_by_path = {p: c.get("add_layer_norm", 0) + c.get("bias_gelu", 0)
                  for p, c in paths.items()}
    kernels.append(summarize_step_norm(k4_rows, k4_by_path["beam"]))
    kernels[-1]["launches_by_path"] = k4_by_path
    for k, name in zip(kernels, ("snake_cmajor", "resblock_cmajor",
                                 "snake_clast", "copy_on_fork")):
        k["launches_by_path"] = by_path(name)
    kernels[0]["launches_note"] = kernels[1]["launches_note"] = (
        "launches: the default beam path (three requests); every path in "
        "launches_by_path")
    kernels[2]["launches_note"] = ("launches: the vocoder-ref stream "
                                   "(stream_device, 600 frames)")
    kernels[1]["widths"] = k2_widths
    kernels[0]["c_le_128_stages"] = k1_stages
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
