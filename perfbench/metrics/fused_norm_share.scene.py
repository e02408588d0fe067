"""Per cent of the beam decode's steps (the engine's ``decode.step`` spans)
whose bias, residual, LayerNorm and GELU chains ran on kernel K4 in every
layer, over the device-only traced stretch."""
from perfbench import norm_spans


def read(data):
    return norm_spans.fused_norm_share(data)
