"""The program's vocoder time (StageTimes.bigvgan) over the audio seconds,
summed over the window."""
from perfbench import measure


def read(data):
    return measure.vocoder_s_per_audio_s(data)
