"""The program's vocoder time (F5Times.bigvgan: the window plan, the exact
patches and the int16 emission) over the audio seconds, summed over the
window."""
from perfbench import measure


def read(data):
    return measure.vocoder_s_per_audio_s(data)
