"""Per cent of the beam decode's steps (the engine's ``decode.step`` spans)
whose attention ran on kernel K3 in every layer, over the device-only
traced stretch."""
from perfbench import anc_spans


def read(data):
    return anc_spans.anc_attn_share(data)
