"""Per cent: K2's least time at its launches' shapes (convs at the dtype's
tensor-core peak, or bytes at 3.35 TB/s) over its device time in the
profiler trace."""
from perfbench import measure


def read(data):
    return measure.k2_roofline(data)
