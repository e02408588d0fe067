"""High-quality stretch: conservative clamp [0.8, 1.3] + quality-risk
warnings (spec: srt_dubbing/src/strategies/hq_stretch_strategy.py)."""
from __future__ import annotations

from index_tts_dubbing_tpu_torch.dubbing.config import STRATEGY
from index_tts_dubbing_tpu_torch.dubbing.logger import get_logger
from index_tts_dubbing_tpu_torch.dubbing.strategies.stretch import StretchStrategy


class HighQualityStretchStrategy(StretchStrategy):
    max_default = STRATEGY.HIGH_QUALITY_MAX_SPEED
    min_default = STRATEGY.HIGH_QUALITY_MIN_SPEED

    @staticmethod
    def name() -> str:
        return "hq_stretch"

    @staticmethod
    def description() -> str:
        return "conservative time-stretch prioritising audio quality"

    def _quality_check(self, entry, rate: float) -> None:
        log = get_logger()
        if rate > 1.2:
            log.warning(f"entry {entry.index}: speed-up {rate:.2f}x risks "
                        "audible artifacts")
        elif rate < 0.85:
            log.warning(f"entry {entry.index}: slow-down {rate:.2f}x risks "
                        "smearing transients")
