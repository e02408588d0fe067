"""Readings for the limits of ``correct``: the program's and the control's
numbers on many seeds, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--out calibrate.jsonl]

For each seed: the cell's program on that seed's weights serves the calls
a run compares (the mix's longest slot and ``check_extra`` more, at the
cell's own sizes), then the plain reference reads the program's numbers
and the control's: the reference in the precision below the
configuration's (``control`` in its file) put in the program's place over
the same prompts, texts and served codes. One JSON line per seed. The
benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import check, harness, traffic, weights  # noqa: E402
from perfbench.reference import Reference  # noqa: E402


def fp8_weights(tree):
    """Every matrix (ndim >= 2) rounded to float8 e4m3 with a per-tensor
    scale (amax to 448), back in bfloat16; vectors in bfloat16."""
    if isinstance(tree, dict):
        return {k: fp8_weights(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fp8_weights(v) for v in tree]
    if not tree.is_floating_point():
        return tree
    x = tree.float()
    if x.dim() < 2:
        return x.to(torch.bfloat16)
    scale = x.abs().max().clamp_min(1e-30) / 448.0
    q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(torch.bfloat16)


def control(params32, cfg):
    """The control: the reference one precision below the
    configuration's."""
    kind = cfg["control"]
    if kind == "fp8_weights_bf16":
        return Reference(fp8_weights(params32), cfg, torch.bfloat16)
    if kind == "bfloat16":
        return Reference(weights.cast(params32, torch.bfloat16), cfg,
                         torch.bfloat16)
    raise ValueError(f"unknown control {kind!r}")


def compared_calls(mix, seed):
    """The calls a run compares: the longest slot and ``check_extra`` more
    slots, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 4])
    slots = mix["slots"]
    longest = max(range(len(slots)), key=lambda i: slots[i]["cap"])
    others = [i for i in range(len(slots)) if i != longest]
    picked = [longest] + [int(i) for i in rng.permutation(others)
                          [: int(mix.get("check_extra", 2))]]
    return [traffic.slot_call(mix, rng, n, i) for n, i in enumerate(picked)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    cell = harness.load_cell(Path(args.root), args.workload)
    if dev == "cuda":
        harness.require_chips(cell.chips)
    cfg = cell.config
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as wd:
            prog = harness.Program(cell, seed, dev, Path(wd))
            records = [prog.serve(c) for c in compared_calls(cell.mix, seed)]
            harness.host_codes(records)
            prompt = prog.prompt
            prog.free()
            del prog
            t1 = time.perf_counter()
            idx = list(range(len(records)))
            p32 = weights.cast(weights.make(cfg, seed, dev,
                                            harness.DTYPES[cfg["dtype"]]),
                               torch.float32)
            ref = Reference(p32, cfg, torch.float32)
            ref.set_prompt(prompt)
            dec = cell.mix["decode"]
            prog_read = check.readings(ref, records, idx, cfg, dec, seed)
            t2 = time.perf_counter()
            low = control(p32, cfg)
            low.set_prompt(prompt)
            ctrl_read = check.readings(ref, records, idx, cfg, dec, seed,
                                       low=low)
            t3 = time.perf_counter()
            del ref, low, p32
            if dev == "cuda":
                torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed,
                "errors": [r["error"] for r in records if r["error"]],
                "program": prog_read, "control": ctrl_read,
                "serve_s": t1 - t0, "reference_s": t2 - t1,
                "control_s": t3 - t2,
                "device": (torch.cuda.get_device_name(0) if dev == "cuda"
                           else dev)}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
