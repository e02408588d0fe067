"""Per cent of the decode's steps (the engine's ``decode.step`` spans) that
ran as the replay of a captured CUDA graph, over the device-only traced
stretch."""
from perfbench import graph_spans


def read(data):
    return graph_spans.graph_step_share(data)
