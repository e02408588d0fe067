"""Model families: what the harness knows of one model, behind one module.

A configuration's file names its family under ``"family"``; without the
key the family is ``"indextts"``. The harness loads
``perfbench/families/<family>.py`` by file path, as it loads a metric's
reader, so a new family is one new file. The closed loop, the window, the
traced stretches, ``check.sample``, ``check.judge``, the metric readers
and the result line are the harness's; a family module supplies the rest:

- ``check_mix(mix, path)``: raises ``ValueError`` for a mix the family
  cannot serve or check (its ``entry``, its own keys). The generic keys,
  ``entry``, ``slots`` (each with ``cap`` and ``chars``) and
  ``prompt_seconds``, are checked by ``traffic.load``.
- ``call_kwargs(mix, slot) -> dict``: the keyword arguments of one call of
  the mix's slot ``slot`` (an index).
- ``Program(cell, seed, device, workdir)``: the system under test on
  weights it draws from the seed and on the benchmark's prompt.
  Attributes ``dtype`` (the configuration's dtype name), ``prompt`` (the
  prompt wav it wrote under ``workdir``) and ``cuda``; methods
  ``serve(call) -> record``, ``sync()`` and ``free()``. A record holds
  the keys the generic readers and ``check.sample`` read: ``index``,
  ``slot``, ``cap``, ``texts``, ``t0``, ``t1``, ``audio_s``, ``error``
  (None, or the call's exception as text) and ``wav`` (absent after an
  error). Any other key is the family's; a tensor in a record is
  moved to the host before the program is freed.
- ``compare(records, idx, cfg, mix, seed, prompt, device,
  as_control=False) -> dict``: the family's plain float32 reference, on
  weights it draws again from the seed, over the records at ``idx``: every
  number the cell's limits file names, and ``compared``, the count of
  units compared (``correct`` needs it above 0). With ``as_control`` the
  numbers of the control in the program's place.
- ``control(params32, cfg)``: the control, the reference one precision
  below the configuration's.
- ``trace_hook()``: a context manager around the device-only traced
  stretch; it yields the list of kernel launches it records
  (``RunData.k2_launches``).
- ``CALL_COLUMNS`` and ``call_columns(record) -> str``: the family's
  columns of the per-call lines on standard error, after ``call slot cap
  wall_s audio_s``.
- ``compared_line(read) -> str``: the line on standard error before the
  compared numbers, saying what was compared.
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict

ROOT = Path(__file__).resolve().parent.parent.parent
DEFAULT = "indextts"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_-]{0,63}")


def load(name: str = DEFAULT, root: Path = ROOT) -> ModuleType:
    """The family module ``perfbench/families/<name>.py`` under ``root``."""
    path = Path(root) / "perfbench" / "families" / f"{name}.py"
    if not NAME.fullmatch(name) or not path.is_file():
        raise ValueError(f"unknown model family {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_family_{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def of(config: Dict[str, Any], root: Path = ROOT) -> ModuleType:
    """The family a configuration names."""
    return load(config.get("family", DEFAULT), root)
