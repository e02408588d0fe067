"""Summed wall over summed audio seconds of the window's calls."""
from perfbench import measure


def read(data):
    return measure.summed_rtf(data)
