"""Audio seconds served over the window's wall: whole calls, the last being the
first to end after the window's length."""
from perfbench import measure


def read(data):
    return measure.audio_per_s(data)
