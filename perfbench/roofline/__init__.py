"""Peaks of the card and the operations and bytes of the work, from shapes.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates without sparsity,
at the full 700 W power limit.

``k2_*``: kernel K2 (one whole AMP resblock of BigVGAN's C <= 128 stages,
``csrc/resblock_cmajor.cu``) on a (B, C, T) launch: six k-tap C×C convs
over T outputs each (the chain's shrinking margins are the kernel's own
overhead, not the work), six anti-aliased snakes (58 float32 operations an
output: two 6-tap up-phases, two snakes, a 12-tap down-filter), and each
byte read once and written once: x in, out back, the packed weights.

``model_flops``: the model's multiply-adds of one served call, counted
twice each: the GPT's prefill, every decode step of every beam row, the
latent pass, and BigVGAN's convolutions for the frames served. Norms,
softmax, activations and the conditioning encoders are left out.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

PEAK_OPS = {"bfloat16": 989e12,   # dense bf16 tensor cores
            "float32": 495e12}    # dense TF32 tensor cores: no float32
                                  # implementation of the work is faster
FP32_OPS = 67e12                  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
ACT_OPS = 58                      # float32 operations an activation output
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def k2_conv_ops(b: int, c: int, t: int, k: int) -> float:
    """Operations of K2's six convs at one launch."""
    return 2.0 * b * t * 6 * c * c * k


def k2_act_ops(b: int, c: int, t: int) -> float:
    return 6.0 * b * c * t * ACT_OPS


def k2_bytes(b: int, c: int, t: int, k: int, dtype: str) -> float:
    """x read, out written, and the packed weights (w1, w2 in the compute
    dtype; b1, b2 and the four activation rows of α and 1/β in float32) at
    the unpadded width."""
    es = DTYPE_BYTES[dtype]
    weights = 2 * 3 * k * c * c * es + 2 * 3 * c * 4 + 3 * 4 * c * 4
    return 2.0 * b * c * t * es + weights


def k2_bound_s(b: int, c: int, t: int, k: int, dtype: str) -> float:
    """The least time of one launch: its convs at the dtype's tensor-core
    peak, or its bytes at the HBM rate, whichever is longer."""
    return max(k2_conv_ops(b, c, t, k) / PEAK_OPS[dtype],
               k2_bytes(b, c, t, k, dtype) / HBM_BYTES_PER_S)


def k2_bound_fp32_s(b: int, c: int, t: int, k: int) -> float:
    """The float32 bound the port's records state per launch (convs and
    activations at 67 TFLOP/s outside the tensor cores, or bytes)."""
    return max((k2_conv_ops(b, c, t, k) + k2_act_ops(b, c, t)) / FP32_OPS,
               k2_bytes(b, c, t, k, "float32") / HBM_BYTES_PER_S)


def gpt_block_ops(d: int, tokens: float) -> float:
    """qkv, proj and the 4·d MLP of one layer over ``tokens``."""
    return 2.0 * tokens * (3 * d * d + d * d + 8 * d * d)


def gpt_prefill_ops(g: Dict[str, Any], s: int) -> float:
    """A causal pass over ``s`` positions, then the mel head once."""
    d, n = g["model_dim"], g["layers"]
    attn = 2.0 * 2 * d * s * (s + 1) / 2          # scores and values, causal
    return n * (gpt_block_ops(d, s) + attn) + 2.0 * d * g["number_mel_codes"]


def gpt_decode_ops(g: Dict[str, Any], s0: int, steps: int) -> float:
    """``steps - 1`` cached steps of one row after a prefix of ``s0``
    positions (the prefill gives the first code): each step's blocks over
    one token, attention over the cache so far, and the mel head."""
    d, n = g["model_dim"], g["layers"]
    if steps <= 1:
        return 0.0
    ctx = sum(s0 + j for j in range(1, steps))
    return (n * (gpt_block_ops(d, steps - 1) + 2.0 * 2 * d * ctx)
            + 2.0 * d * g["number_mel_codes"] * (steps - 1))


def bigvgan_ops_per_frame(b: Dict[str, Any]) -> float:
    """BigVGAN's convolutions for one latent frame of output."""
    ch = b["upsample_initial_channel"]
    ops = 2.0 * b["gpt_dim"] * ch * 7                  # conv_pre
    samples = 1
    for i, (u, k) in enumerate(zip(b["upsample_rates"],
                                   b["upsample_kernel_sizes"])):
        c_out = b["upsample_initial_channel"] // 2 ** (i + 1)
        ops += 2.0 * ch * c_out * k * samples          # transposed conv
        samples *= u
        ops += sum(2.0 * 6 * c_out * c_out * kk * samples
                   for kk in b["resblock_kernel_sizes"])
        ch = c_out
    return ops + 2.0 * ch * 7 * samples                # conv_post


def model_flops(cfg: Dict[str, Any], text_tokens: Sequence[int],
                beams: int, steps: int, frames: Sequence[int]) -> float:
    """One call: rows of ``text_tokens`` tokens, each decoded ``steps``
    steps by ``beams`` beams and served with ``frames`` latent frames."""
    g = cfg["gpt"]
    lat = g["condition_num_latent"]
    total = 0.0
    for n_text, n_frames in zip(text_tokens, frames):
        s0 = lat + n_text + 2 + 1
        total += gpt_prefill_ops(g, s0)
        total += beams * gpt_decode_ops(g, s0, steps)
        total += gpt_prefill_ops(g, lat + n_text + 2 + n_frames + 2) \
            - 2.0 * g["model_dim"] * g["number_mel_codes"]
        total += n_frames * bigvgan_ops_per_frame(cfg["bigvgan"])
    return total
