#!/usr/bin/env python3
"""Kernel K2 (index_tts_dubbing_tpu_torch/csrc/resblock_cmajor.cuh, built
from resblock_cmajor.cu and resblock_cmajor_exact.cu) alone on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_k2_check.py [--no-time]
    python3 tools/torch_k2_check.py --variants [--out _chipcheck/variants]

The first form prints nvidia-smi's name and power limit, ptxas's lines for
every K2 instantiation (registers, stack, spills), and one JSON line per
case: K2 against its plain version at the nine shapes of one vocoder
window batch and at ragged ones, in float32 and bfloat16, with the float32
time beside the plain version's at the nine shapes, then chip_smoke.py's
``check_k2_widths`` (every padded width class, timed). It exits non-zero if
any case is outside chip_smoke.py's TOL.

``--variants`` shows where K2's time goes: its float32 time per window
batch at the nine shapes for the checkout's kernel and for copies of it
that each change one thing (VARIANTS), each copy under ``--out`` (a
git-ignored directory), built into its own library and timed in its own
process, in turns: checkout, the variants, checkout. Variants that drop
work on purpose ("one_pass", "no_activations") compute wrong results;
they are timings only.
"""
import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "index_tts_dubbing_tpu_torch"
CU = "csrc/resblock_cmajor.cuh"
RAGGED = [(96, 1000, 11, 3), (48, 777, 7, 1), (24, 700, 3, 2), (96, 37, 3, 1)]
# name -> [(file in the package, old text, new text)]
VARIANTS = {
    # one TF32 pass for float32: the cost of the two extra passes
    "one_pass": [(CU, "constexpr bool kSplit = std::is_same<T, float>::value;",
                  "constexpr bool kSplit = false;")],
    # every activation returns at once: the activations' share
    "no_activations": [(CU, "  const int nout = n - 12;\n  for (int c = warp;",
                        "  const int nout = n - 12;\n"
                        "  if (n > 0) { __syncthreads(); return; }\n"
                        "  for (int c = warp;")],
    # 128-column conv chunks (half the columns per loaded weight)
    "chunk_128": [(CU, "kNT = kWM == 2 ? 8 : 4;", "kNT = kWM == 2 ? 4 : 2;"),
                  (CU, "static_assert(kNC == 256", "static_assert(kNC == 128")],
    # tiles capped at 512 columns (C <= 48 take 512 instead of 768)
    "tile_cap_512": [("ops/resblock_cmajor.py", "_MAX_TILE = 768",
                      "_MAX_TILE = 512")],
}


def ptxas_report() -> str:
    """ptxas -v for K2's two sources (its default and exact-edge modes),
    compiled as the library is."""
    from index_tts_dubbing_tpu_torch.ops import cuda_lib
    lines = []
    for name in ("resblock_cmajor.cu", "resblock_cmajor_exact.cu"):
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c",
               "-o", "/dev/null", str(cuda_lib.CSRC_DIR / name)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=cuda_lib.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
        lines += [line for line in proc.stderr.splitlines()
                  if "resblock" in line or "registers" in line
                  or "spill" in line]
    return "\n".join(lines)


def inputs(gen, c, t, k, b, dt):
    """chip_smoke.py's K2 inputs: packed weights and x of (b, c, t)."""
    import torch
    import chip_smoke as smoke
    from index_tts_dubbing_tpu_torch.config import EngineConfig
    from index_tts_dubbing_tpu_torch.ops import resblock_cmajor as k2
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    w = k2.pack_resblock(smoke.rand_resblock(rand, c, k),
                         EngineConfig().bigvgan, dt)
    return w, (rand(b, c, t) * 0.5).to(dt)


def check(gen, c, t, k, b, dt, timed):
    import chip_smoke as smoke
    from index_tts_dubbing_tpu_torch.ops import resblock_cmajor as k2
    w, x = inputs(gen, c, t, k, b, dt)
    ref = k2.resblock_cmajor_plain(x, *w, k, smoke.DILS).float()
    got = k2.resblock_cmajor(x, *w, k, smoke.DILS).float()
    err = (got - ref).abs().max().item()
    lim = smoke.TOL[dt] * max(1.0, ref.abs().max().item())
    row = {"dtype": str(dt), "C": c, "T": t, "k": k, "B": b,
           "tt": k2.pick_tile(c, k, smoke.DILS, t), "max_abs_err": err,
           "tol": lim, "ok": err <= lim}
    if timed:
        row["ms"] = smoke.cuda_ms(lambda: k2.resblock_cmajor(x, *w, k, smoke.DILS), 3)
        row["plain_ms"] = smoke.cuda_ms(
            lambda: k2.resblock_cmajor_plain(x, *w, k, smoke.DILS), 2)
    return row


def time_nine() -> dict:
    """Float32 K2 ms at the nine shapes, from the package first on
    sys.path."""
    import torch
    import chip_smoke as smoke
    from index_tts_dubbing_tpu_torch.ops import cuda_lib
    from index_tts_dubbing_tpu_torch.ops import resblock_cmajor as k2
    cuda_lib.load()
    gen = torch.Generator("cuda").manual_seed(0)
    shapes = []
    for c, t, k in smoke.K2_SHAPES:
        w, x = inputs(gen, c, t, k, smoke.WINDOW_BATCH, torch.float32)
        ms = smoke.cuda_ms(lambda: k2.resblock_cmajor(x, *w, k, smoke.DILS), 5)
        shapes.append({"C": c, "k": k, "tt": k2.pick_tile(c, k, smoke.DILS, t),
                       "ms": ms})
    return {"ms": sum(s["ms"] for s in shapes), "shapes": shapes}


def make_variant(out: Path, name: str) -> Path:
    root = out / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in VARIANTS[name]:
        path = root / PKG / rel
        text = path.read_text()
        if old not in text:
            raise ValueError(f"{name}: {old!r} not in {rel}")
        path.write_text(text.replace(old, new))
    return root


def run_variants(out: Path) -> int:
    roots = {"checkout": ROOT}
    roots.update({name: make_variant(out, name) for name in VARIANTS})
    for name in ["checkout", *VARIANTS, "checkout"]:
        proc = subprocess.run([sys.executable, __file__, "--time-from",
                               str(roots[name])], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"variant": name, **row}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--no-time", action="store_true",
                    help="check only; skip the timings")
    ap.add_argument("--variants", action="store_true",
                    help="time the kernel beside its one-change variants")
    ap.add_argument("--out", default="_chipcheck/variants",
                    help="git-ignored directory for the variant copies")
    ap.add_argument("--time-from", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_from:               # one variant's timing, in its own process
        sys.path[:0] = [args.time_from, str(ROOT)]
        print(json.dumps(time_nine()))
        return 0
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.variants:
        return run_variants((ROOT / args.out).resolve())
    import chip_smoke as smoke
    from index_tts_dubbing_tpu_torch.ops import cuda_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(ptxas_report(), flush=True)
    cuda_lib.load()
    print(f"build {cuda_lib.last_build_seconds or 0.0:.2f} s", flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    ok = True
    cases = [(c, t, k, smoke.WINDOW_BATCH) for c, t, k in smoke.K2_SHAPES]
    for dt in (torch.float32, torch.bfloat16):
        for c, t, k, b in cases + RAGGED:
            timed = (not args.no_time and dt == torch.float32
                     and (c, t, k, b) in cases)
            row = check(gen, c, t, k, b, dt, timed)
            ok &= row["ok"]
            print(json.dumps(row), flush=True)
    for row in smoke.check_k2_widths(gen):      # raises outside TOL
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
