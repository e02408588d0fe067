"""Strategy registry with auto-discovery of TimeSyncStrategy subclasses
(spec: srt_dubbing/src/strategies/__init__.py:17-60)."""
from __future__ import annotations

import inspect
from typing import Dict, List, Optional, Type

from index_tts_dubbing_tpu_torch.dubbing.engines.base import BaseTTSEngine
from index_tts_dubbing_tpu_torch.dubbing.strategies.base import TimeSyncStrategy
from index_tts_dubbing_tpu_torch.dubbing.strategies.basic import BasicStrategy
from index_tts_dubbing_tpu_torch.dubbing.strategies.stretch import StretchStrategy
from index_tts_dubbing_tpu_torch.dubbing.strategies.hq_stretch import (
    HighQualityStretchStrategy)
from index_tts_dubbing_tpu_torch.dubbing.strategies.adaptive import AdaptiveStrategy

_STRATEGIES: Dict[str, Type[TimeSyncStrategy]] = {}


def _register_strategies() -> None:
    import index_tts_dubbing_tpu_torch.dubbing.strategies as pkg
    for _, obj in inspect.getmembers(pkg):
        if (inspect.isclass(obj) and issubclass(obj, TimeSyncStrategy)
                and obj is not TimeSyncStrategy):
            _STRATEGIES[obj.name()] = obj


_register_strategies()


def list_available_strategies() -> List[str]:
    return sorted(_STRATEGIES)


def get_strategy_description(name: str) -> str:
    return _STRATEGIES[name].description() if name in _STRATEGIES else ""


def get_strategy(name: str, tts_engine: Optional[BaseTTSEngine] = None,
                 **kwargs) -> TimeSyncStrategy:
    if name not in _STRATEGIES:
        raise ValueError(f"unknown strategy: {name!r}; "
                         f"available: {list_available_strategies()}")
    return _STRATEGIES[name](tts_engine, **kwargs)
