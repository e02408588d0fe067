"""Mean device ms of one guided S2M DiT forward (the engine's ``s2m.nfe``
spans: the conditioned and unconditioned rows as one batch, the guidance,
the Euler update and the prompt frames held), over the device-only traced
stretch."""
from perfbench import spans


def read(data):
    reqs = spans.traced_requests(data)
    if reqs is None:
        return None
    ms = [s.device_ms for r in reqs for s in r
          if s.name == "s2m.nfe" and s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
