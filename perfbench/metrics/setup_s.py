"""Seconds from the process's start to the first timed call: imports, CUDA, the
kernel library (built on a checkout's first run), weights from the seed, the
prompt and one warm-up call of every slot of the mix."""


def read(data):
    return data.setup_s
