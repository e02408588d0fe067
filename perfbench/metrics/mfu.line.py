"""Per cent of the dtype's peak (989 TFLOP/s bf16, 495 TFLOP/s TF32 for
float32) that the model FLOPs of the window's calls take of its wall."""
from perfbench import measure


def read(data):
    return measure.mfu(data)
