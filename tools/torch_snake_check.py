#!/usr/bin/env python3
"""Kernels K1 (index_tts_dubbing_tpu_torch/csrc/snake_cmajor.cu) and B3
(csrc/snake_clast.cu) alone on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 tools/torch_snake_check.py [--no-time]
    python3 tools/torch_snake_check.py --variants [--parent DIR] [--out DIR]

The first form prints nvidia-smi's name and power limit, ptxas's lines for
every K1 and B3 instantiation (registers, stack, spills), and one JSON line
per case: each kernel against its plain version at the shapes of one
vocoder window batch (chip_smoke.py's K1_SHAPES, B3_SHAPES) and at its
ragged ones (K1_RAGGED, B3_RAGGED), in float32 and bfloat16, with the
float32 time beside the plain version's at the window-batch shapes. It
exits non-zero if any case is outside chip_smoke.py's TOL.

``--variants`` shows where the time goes: float32 ms per window batch of
K1 and B3 (per shape too, with a PyTorch copy of the same tensor beside
each, ``copy_ms``: the bytes moved by the card's own copy kernel), and of
K2, copy_on_fork and the gather beside them, for the checkout and for copies of it that each change one thing
(VARIANTS), each copy under ``--out`` (a git-ignored directory), built into
its own library and timed in its own process, in turns: [parent,]
checkout, the variants, checkout[, parent]. ``--parent DIR`` names a
directory that holds another commit's ``index_tts_dubbing_tpu_torch`` (a
``git archive`` of it). The variants "no_sine" and "copy_only" compute
wrong results; they are timings only.
"""
import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "index_tts_dubbing_tpu_torch"
MATH = "csrc/snake_math.cuh"
SQUARE = "  return s * s;\n}\n\n__device__ __forceinline__ bool past_limit"
# name -> [(file in the package, old text, new text)]. K1's run is not a
# variant: 8 outputs is two 16-byte vectors, and its 5-input halo comes from
# one neighbour (runs of 4, one vector a lane and the halo from two lanes,
# measured slower).
VARIANTS = {
    # the accurate sinf in place of the range-reduced polynomial: the
    # sine's share
    "accurate_sine": [(MATH, SQUARE, SQUARE.replace(
        "  return s * s;", "  const float t = sinf(y);\n  return t * t;"))],
    # no sine at all (wrong results): the rest of the work
    "no_sine": [(MATH, SQUARE, SQUARE.replace("  return s * s;",
                                              "  return 0.0f;"))],
    # B3: the plan told the card holds half / twice its threads (longer /
    # shorter runs)
    "b3_resident_half": [("ops/snake_clast.py", "vec, resident))",
                          "vec, resident // 2))")],
    "b3_resident_x2": [("ops/snake_clast.py", "vec, resident))",
                        "vec, resident * 2))")],
    # a copy through the kernels' loads and stores, no arithmetic (wrong
    # results): the floor of their access patterns
    "copy_only": [(MATH, "    big |= past_limit(ye) | past_limit(yo);\n",
                   ""),
                  ("csrc/snake_cmajor.cu",
                   "snake_math::store_vec<kRun>(orow + s.tb, y);",
                   "snake_math::store_vec<kRun>(orow + s.tb, s.own);"),
                  ("csrc/snake_clast.cu",
                   "snake_math::store_vec<V>(ob + static_cast<size_t>(t0 + s "
                   "+ k) * C, y);",
                   "snake_math::store_vec<V>(ob + static_cast<size_t>(t0 + s "
                   "+ k) * C, X[(k + 4) % 6]);")],
}


def ptxas_report() -> str:
    """ptxas -v for the two kernels' sources, compiled as the library is."""
    from index_tts_dubbing_tpu_torch.ops import cuda_lib
    lines = []
    for name in ("snake_cmajor.cu", "snake_clast.cu"):
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v",
               "-c", "-o", "/dev/null", str(cuda_lib.CSRC_DIR / name)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=cuda_lib.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
        lines += [line for line in proc.stderr.splitlines()
                  if "snake" in line or "sin2" in line or "registers" in line
                  or "spill" in line or "stack" in line]
    return "\n".join(lines)


def _input(gen, b, d1, d2, dt, offset=0):
    import torch
    flat = torch.randn(b * d1 * d2 + offset, generator=gen, device="cuda")
    return flat.to(dt)[offset:].view(b, d1, d2)


def check(gen, name, b, d1, d2, dt, offset, timed):
    import torch
    import chip_smoke as smoke
    from index_tts_dubbing_tpu_torch.ops import snake_clast as b3
    from index_tts_dubbing_tpu_torch.ops import snake_cmajor as k1
    fn, plain = ((k1.snake_cmajor, k1.snake_cmajor_plain) if name == "K1"
                 else (b3.snake_clast, b3.snake_clast_plain))
    c = d1 if name == "K1" else d2
    x = _input(gen, b, d1, d2, dt, offset)
    al = torch.randn(c, generator=gen, device="cuda") * 0.3
    be = torch.randn(c, generator=gen, device="cuda") * 0.3
    ref = plain(x, al, be, True).float()
    got = fn(x, al, be, True).float()
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    lim = smoke.TOL[dt] * max(1.0, ref.abs().max().item())
    row = {"kernel": name, "dtype": str(dt), "shape": [b, d1, d2],
           "offset": offset, "max_abs_err": err, "tol": lim, "ok": err <= lim}
    if name == "K1":
        row["run"] = k1.RUN
        row["vec"], row["lanes_per_row"], row["passes"], row["chunk"] = (
            k1.launch_plan(x))
    else:
        row["vec"], row["run"], row["runs"], row["threads"] = (
            b3.launch_plan(x))
    if timed:
        row["ms"] = smoke.cuda_ms(lambda: fn(x, al, be, True), 10)
        row["plain_ms"] = smoke.cuda_ms(lambda: plain(x, al, be, True), 3)
    return row


def time_all() -> dict:
    """Float32 ms per window batch of K1 and B3 (and per shape), K2's nine
    shapes, and one copy_on_fork and gather call at chip_smoke.py's headline
    cases, from the package first on sys.path."""
    import torch
    import chip_smoke as smoke
    from index_tts_dubbing_tpu_torch.config import EngineConfig
    from index_tts_dubbing_tpu_torch.ops import cuda_lib, permute
    from index_tts_dubbing_tpu_torch.ops import resblock_cmajor as k2
    from index_tts_dubbing_tpu_torch.ops import snake_clast as b3
    from index_tts_dubbing_tpu_torch.ops import snake_cmajor as k1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.load()
    gen = torch.Generator("cuda").manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    out = {}
    for name, fn, shapes, cmajor in (
            ("K1", k1.snake_cmajor, smoke.K1_SHAPES, True),
            ("B3", b3.snake_clast, smoke.B3_SHAPES, False)):
        rows = []
        for c, t, per_batch in shapes:
            x = rand(smoke.WINDOW_BATCH, *((c, t) if cmajor else (t, c)))
            al, be = rand(c) * 0.3, rand(c) * 0.3
            ms = smoke.cuda_ms(lambda: fn(x, al, be, True), 10)
            y = torch.empty_like(x)
            copy_ms = smoke.cuda_ms(lambda: y.copy_(x), 10)
            rows.append({"C": c, "T": t, "per_batch": per_batch, "ms": ms,
                         "copy_ms": copy_ms})
        out[name] = {"ms": sum(r["ms"] * r["per_batch"] for r in rows),
                     "copy_ms": sum(r["copy_ms"] * r["per_batch"]
                                    for r in rows),
                     "shapes": rows}
    k2_ms = 0.0
    for c, t, k in smoke.K2_SHAPES:
        conv = lambda: {"w": rand(k, c, c) * 0.1, "b": rand(c) * 0.1}
        rb = {"convs1": [conv() for _ in range(3)],
              "convs2": [conv() for _ in range(3)],
              "acts": [{"alpha": rand(c) * 0.3, "beta": rand(c) * 0.3}
                       for _ in range(6)]}
        w = k2.pack_resblock(rb, EngineConfig().bigvgan, torch.float32)
        x = rand(smoke.WINDOW_BATCH, c, t) * 0.5
        k2_ms += smoke.cuda_ms(lambda: k2.resblock_cmajor(x, *w, k, smoke.DILS), 3)
    out["K2"] = {"ms": k2_ms}
    kg = rand(*smoke.GEN_CACHE).to(torch.bfloat16)
    vg = rand(*smoke.GEN_CACHE).to(torch.bfloat16)
    pattern, bound = smoke.COF_HEADLINE
    cp = torch.tensor(smoke.CP_PATTERNS[pattern], dtype=torch.int32,
                      device="cuda")
    out["copy_on_fork"] = {"ms": smoke.cuda_ms(
        lambda: permute.copy_on_fork(kg, vg, cp, bound), 20)}
    src = torch.tensor(smoke._gather_sources()[smoke.GATHER_HEADLINE[0]],
                       dtype=torch.int32, device="cuda")
    out["gather"] = {"ms": smoke.cuda_ms(
        lambda: permute.permute_gen_cache(kg, vg, src), 20)}
    return out


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


def run_variants(out: Path, parent) -> int:
    roots = {"checkout": ROOT}
    roots.update({name: make_variant(out, name) for name in VARIANTS})
    order = ["checkout", *VARIANTS, "checkout"]
    if parent:
        roots["parent"] = Path(parent).resolve()
        order = ["parent", *order, "parent"]
    for name in order:
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
                    help="time the kernels beside their one-change variants")
    ap.add_argument("--parent", help="a directory holding another commit's "
                                     "package, timed first and last")
    ap.add_argument("--out", default="_chipcheck/variants",
                    help="git-ignored directory for the variant copies")
    ap.add_argument("--time-from", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_from:               # one tree's timing, in its own process
        sys.path[:0] = [args.time_from, str(ROOT)]
        print(json.dumps(time_all()))
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
        return run_variants((ROOT / args.out).resolve(), args.parent)
    import chip_smoke as smoke
    from index_tts_dubbing_tpu_torch.ops import cuda_lib
    print(ptxas_report(), flush=True)
    cuda_lib.load()
    print(f"build {cuda_lib.last_build_seconds or 0.0:.2f} s", flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    ok = True
    cases = ([("K1", smoke.WINDOW_BATCH, c, t, 0, True)
              for c, t, _ in smoke.K1_SHAPES]
             + [("K1", *r, False) for r in smoke.K1_RAGGED]
             + [("B3", smoke.WINDOW_BATCH, t, c, 0, True)
                for c, t, _ in smoke.B3_SHAPES]
             + [("B3", *r, False) for r in smoke.B3_RAGGED])
    for dt in (torch.float32, torch.bfloat16):
        for name, b, d1, d2, offset, main_path in cases:
            timed = not args.no_time and dt == torch.float32 and main_path
            row = check(gen, name, b, d1, d2, dt, offset, timed)
            ok &= row["ok"]
            print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
