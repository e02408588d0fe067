"""Per cent of the bf16 tensor cores' 989 TFLOP/s that the model FLOPs of
the window's calls take of its wall (perfbench/roofline/f5tts.py: the
guided DiT at each row's own frames every step, the text encoder, the
vocoder's convolutions per generated frame)."""
from perfbench import measure, roofline
from perfbench.roofline import f5tts


def read(data):
    cfg = data.cell.config
    calls = measure.ok(data)
    if not calls or any("prompt_frames" not in r for r in calls):
        return None
    flops = sum(f5tts.call_flops(cfg, r["frames"], r["prompt_frames"],
                                 r["nfe"]) for r in calls)
    if flops <= 0:
        return None
    return 100.0 * flops / (data.window_s * roofline.PEAK_OPS[data.dtype])
