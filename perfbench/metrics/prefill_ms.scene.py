"""Mean device ms a call of the decode's prefill (the engine's
``decode.prefill`` spans: prefix embedding, trunk prefill, first candidate
selection), over the device-only traced stretch."""
from perfbench import spans


def read(data):
    return spans.prefill_ms(data)
