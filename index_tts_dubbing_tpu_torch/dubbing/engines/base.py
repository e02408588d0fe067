"""TTS engine ABC (spec: srt_dubbing/src/tts_engines/base_engine.py)."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Tuple

import numpy as np


class BaseTTSEngine(ABC):
    """Engine contract: synthesize(text) -> (float32 audio, sample_rate);
    optionally synthesize_to_duration for duration-aware strategies."""

    @abstractmethod
    def synthesize(self, text: str, **kwargs) -> Tuple[np.ndarray, int]:
        ...

    def synthesize_to_duration(self, text: str, target_duration: float,
                               **kwargs) -> Tuple[np.ndarray, int]:
        raise NotImplementedError(
            f"{type(self).__name__} does not support duration-targeted "
            "synthesis")

    @property
    def supports_duration_control(self) -> bool:
        return type(self).synthesize_to_duration \
            is not BaseTTSEngine.synthesize_to_duration
