"""Per cent of the bf16 tensor cores' 989 TFLOP/s that the model FLOPs of
the window's calls take of its wall (perfbench/roofline/indextts2.py: the
GPT's prefill, decode steps of every beam row and latent pass, the guided
S2M DiT with its WaveNet head at each row's own frames every step, the
vocoder's convolutions per generated frame)."""
import numpy as np

from perfbench import check, measure, roofline
from perfbench.roofline import indextts2


def read(data):
    cfg = data.cell.config
    calls = measure.ok(data)
    if not calls or any("raw_codes" not in r for r in calls):
        return None
    stop = cfg["gpt"]["stop_mel_token"]
    flops = 0.0
    for r in calls:
        tokens = [sum(not c.isspace() for c in t) for t in r["texts"]]
        lens = []
        for row in r["raw_codes"]:
            row = np.asarray(row)
            n = check.served_length(row, stop)
            lens.append(n - 1 if row[n - 1] == stop else n)
        flops += indextts2.call_flops(cfg, tokens, lens, r["beams"],
                                      r["steps"], r["frames"],
                                      r["prompt_frames"], r["nfe"])
    if flops <= 0:
        return None
    return 100.0 * flops / (data.window_s * roofline.PEAK_OPS[data.dtype])
