"""Mean host ms of one decode step (the engine's ``decode.step`` span, less
the host waits on the device inside it), over the device-only traced
stretch."""
from perfbench import spans


def read(data):
    return spans.step_issue_ms(data)
