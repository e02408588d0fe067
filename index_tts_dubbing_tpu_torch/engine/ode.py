"""The guided Euler ODE that F5-TTS (engine/f5.py) and IndexTTS-2's S2M
(engine/indextts2.py) share.

Each step runs one forward over the conditioned rows and the
unconditioned ones stacked as one batch of twice the rows, guides the
velocity ``v = v_c + (v_c − v_u)·cfg`` and moves ``x += Δt·v``; a model
that holds part of the state (IndexTTS-2's prompt frames) gives ``hold``,
applied after each step. Each step is the span ``<name>`` (attribute
``step``) on the device. ``row_noise`` draws both models' starts.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from index_tts_dubbing_tpu_torch.utils import profiling


def guided_euler(x: torch.Tensor, dts: torch.Tensor,
                 velocity: Callable[[int, torch.Tensor], torch.Tensor],
                 cfg_strength: float, name: str,
                 hold: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> torch.Tensor:
    """x (B, ...) float32 through ``len(dts)`` steps; ``velocity(s, xx)``
    gives the (2B, ...) velocities of step s for the stacked ``xx``
    (2B, ...), conditioned rows first."""
    for s in range(dts.shape[0]):
        with profiling.span(name, device=x.device, step=s):
            v_c, v_u = velocity(s, torch.cat([x, x])).chunk(2)
            x = x + dts[s] * (v_c + (v_c - v_u) * cfg_strength)
            if hold is not None:
                x = hold(x)
    return x


def row_noise(durs: Sequence[int], n: int, m: int, seed: int, device
              ) -> torch.Tensor:
    """The ODE's start (rows, n, m) float32: row i's first durs[i] frames
    N(0, 1) from a generator on ``device`` seeded with ``seed + i``, drawn
    as (durs[i], m); zeros past them. A row's noise is then the same in
    any batch."""
    noise = torch.zeros((len(durs), n, m), dtype=torch.float32,
                        device=device)
    for i, d in enumerate(durs):
        g = torch.Generator(device).manual_seed(seed + i)
        noise[i, :d] = torch.randn((d, m), generator=g, device=device)
    return noise
