"""The program's own decode time (decode, trim and latent pass:
StageTimes.gpt_gen) over its decode steps, summed over the window."""
from perfbench import measure


def read(data):
    return measure.decode_ms_per_step(data)
