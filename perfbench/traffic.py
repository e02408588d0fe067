"""The one traffic generator: a closed loop of calls drawn from a mix file.

A mix file (``perfbench/traffic/<name>.json``) lists ``slots``; each slot
is one call of the mix's ``entry``: its cap ``cap`` (for IndexTTS the
decode cap in mel codes) and the token count of each of its texts
(``chars``). The model family the cell's configuration names checks the
mix's own keys and gives each call its keyword arguments
(``perfbench/families/``); without one, IndexTTS's: every call decodes
with the mix's ``decode`` settings, beam sampling, which the check reads.
The loop runs the slots in cycles. A
mix may group its slots (``cycle``, a list of lists of slot indices): each
cycle runs the groups in an order the seed shuffles, each group's slots in
an order the seed shuffles. Without ``cycle`` the seed shuffles all the
slots. So the seed picks the order and the letters of every text, never
the set of caps and lengths: every seed gives the same work in each
cycle.

A text of n tokens is n - 1 lowercase letters in words of up to 8
letters, then a full stop: one sentence, which the engine's character
tokenizer turns into exactly n ids (one per character that is not a
space).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from perfbench import families

LETTERS = "abcdefghijklmnopqrstuvwxyz"


@dataclass
class Call:
    index: int                 # position in the closed loop, from 0
    slot: int                  # index into the mix's slots
    cap: int                   # max_mel_tokens
    texts: List[str]
    kwargs: Dict[str, Any] = field(default_factory=dict)


def _family(family: Optional[ModuleType]) -> ModuleType:
    return family if family is not None else families.load()


def load(path: Path, family: Optional[ModuleType] = None
         ) -> Dict[str, Any]:
    """The mix file at ``path``, checked by ``family`` (default IndexTTS)."""
    mix = json.loads(Path(path).read_text())
    for key in ("entry", "slots", "prompt_seconds"):
        if key not in mix:
            raise ValueError(f"{path}: traffic mix lacks {key!r}")
    _family(family).check_mix(mix, path)
    return mix


def make_text(rng: np.random.Generator, n_tokens: int) -> str:
    """A sentence of ``n_tokens`` non-space characters ending in '.'."""
    letters = n_tokens - 1
    words = []
    while letters > 0:
        w = min(int(rng.integers(2, 9)), letters)
        words.append("".join(rng.choice(list(LETTERS), size=w)))
        letters -= w
    return " ".join(words) + "."


def slot_call(mix: Dict[str, Any], rng: np.random.Generator, index: int,
              slot: int, family: Optional[ModuleType] = None) -> Call:
    s = mix["slots"][slot]
    texts = [make_text(rng, n) for n in rng.permutation(s["chars"])]
    return Call(index, slot, int(s["cap"]), texts,
                _family(family).call_kwargs(mix, slot))


def cycle_order(mix: Dict[str, Any], rng: np.random.Generator) -> List[int]:
    """The slots of one cycle in the order they run."""
    groups = mix.get("cycle")
    if groups is None:
        return [int(i) for i in rng.permutation(len(mix["slots"]))]
    order = [groups[int(i)] for i in rng.permutation(len(groups))]
    return [int(g[int(i)]) for g in order for i in rng.permutation(len(g))]


def calls(mix: Dict[str, Any], seed: int,
          family: Optional[ModuleType] = None) -> Iterator[Call]:
    """The closed loop's calls, endless, from ``seed``."""
    family = _family(family)
    rng = np.random.default_rng(int(seed))
    index = 0
    while True:
        for slot in cycle_order(mix, rng):
            yield slot_call(mix, rng, index, slot, family)
            index += 1


def warmup_calls(mix: Dict[str, Any], seed: int,
                 family: Optional[ModuleType] = None) -> List[Call]:
    """One call of every slot: every shape the loop will use."""
    family = _family(family)
    rng = np.random.default_rng([int(seed), 1])
    return [slot_call(mix, rng, -1 - i, i, family)
            for i in range(len(mix["slots"]))]


def prompt_wav(mix: Dict[str, Any], seed: int, sample_rate: int
               ) -> np.ndarray:
    """The synthetic voice prompt: ``prompt_seconds`` of a voiced source
    (a 90-180 Hz fundamental with its harmonics, three formant-like
    resonances and a slow vibrato) plus a little noise, float32 in
    [-0.5, 0.5]."""
    rng = np.random.default_rng([int(seed), 2])
    n = int(round(mix["prompt_seconds"] * sample_rate))
    t = np.arange(n) / sample_rate
    f0 = rng.uniform(90.0, 180.0) * (1 + 0.02 * np.sin(2 * np.pi * 5.0 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    formants = rng.uniform([500, 1200, 2400], [800, 1800, 3200])
    wav = np.zeros(n)
    for h in range(1, 30):
        fh = h * f0
        amp = sum(1.0 / (1.0 + ((fh - f) / 150.0) ** 2) for f in formants)
        wav += amp / h * np.sin(h * phase)
    wav += 0.01 * rng.standard_normal(n)
    wav *= 0.5 / np.max(np.abs(wav))
    return wav.astype(np.float32)

