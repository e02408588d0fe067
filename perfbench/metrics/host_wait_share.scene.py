"""Per cent of the calls' host time that the host spent waiting on the
device: the engine's ``sync`` spans over its ``request`` spans, over the
device-only traced stretch."""
from perfbench import spans


def read(data):
    return spans.host_wait_share(data)
