"""Readings for the limits of ``correct``: the program's and the control's
numbers on many seeds, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--out calibrate.jsonl]

For each seed: the cell's program on that seed's weights serves the calls
a run compares (the mix's longest slot and ``check_extra`` more, at the
cell's own sizes), then the plain reference of the configuration's model
family reads the program's numbers and the control's: the reference in
the precision below the configuration's (``control`` in its file) put in
the program's place over the same prompts, texts and served outputs. One
JSON line per seed. The benchmark's own runs never run this.
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

from perfbench import families, harness, traffic  # noqa: E402


def control(params32, cfg):
    """The control of the configuration's model family: its reference one
    precision below the configuration's."""
    return families.of(cfg, ROOT).control(params32, cfg)


def compared_calls(mix, seed, family=None):
    """The calls a run compares: the longest slot and ``check_extra`` more
    slots, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 4])
    slots = mix["slots"]
    longest = max(range(len(slots)), key=lambda i: slots[i]["cap"])
    others = [i for i in range(len(slots)) if i != longest]
    picked = [longest] + [int(i) for i in rng.permutation(others)
                          [: int(mix.get("check_extra", 2))]]
    return [traffic.slot_call(mix, rng, n, i, family)
            for n, i in enumerate(picked)]


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
    cfg, mix, fam = cell.config, cell.mix, cell.family
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as wd:
            prog = harness.Program(cell, seed, dev, Path(wd))
            records = [prog.serve(c)
                       for c in compared_calls(mix, seed, fam)]
            harness.host_codes(records)
            prompt = prog.prompt
            prog.free()
            del prog
            t1 = time.perf_counter()
            idx = list(range(len(records)))
            prog_read = fam.compare(records, idx, cfg, mix, seed, prompt,
                                    dev)
            t2 = time.perf_counter()
            ctrl_read = fam.compare(records, idx, cfg, mix, seed, prompt,
                                    dev, as_control=True)
            t3 = time.perf_counter()
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
