"""Run one cell of the benchmark of ``index_tts_dubbing_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. The last line of standard output is the result, one JSON
object; the numbers compared with the plain reference, each beside its
limit, end standard error. Exits non-zero, with no result, when CUDA or
enough devices are missing, when the port cannot be imported, or when
JAX or the JAX package has been loaded once the window has closed.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".perfbench_cache" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from perfbench import harness
    try:
        result, lines = harness.run(args.workload, args.seed,
                                    args.seconds, bool(args.trace),
                                    T_PROCESS)
    except harness.NoChip as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: modules loaded that the benchmark may not load: "
              f"{', '.join(found)}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
