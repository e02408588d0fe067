"""Per cent of the traced stretch in which no kernel, copy or set ran on the
device: 1 - the union of the device's intervals in the profiler trace over
the stretch's wall."""
from perfbench import measure


def read(data):
    return measure.idle_share(data)
