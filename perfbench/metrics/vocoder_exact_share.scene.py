"""Per cent of the vocoder's device time on the exact route: the engine's
``vocoder.exact`` spans (edge patches, the exact re-vocode of a short
stream) over those and its ``vocoder.plan`` spans (the window batches),
over the device-only traced stretch."""
from perfbench import spans


def read(data):
    return spans.vocoder_exact_share(data)
