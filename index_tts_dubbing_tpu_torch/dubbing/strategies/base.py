"""Time-sync strategy ABC (spec: srt_dubbing/src/strategies/base_strategy.py)."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

from index_tts_dubbing_tpu_torch.dubbing.engines.base import BaseTTSEngine
from index_tts_dubbing_tpu_torch.dubbing.srt_parser import SRTEntry


class TimeSyncStrategy(ABC):
    """process_entries(entries, **kw) → [{audio_data, start_time, end_time,
    text, index, duration}]."""

    def __init__(self, tts_engine: Optional[BaseTTSEngine] = None):
        self.tts_engine = tts_engine

    @staticmethod
    @abstractmethod
    def name() -> str:
        ...

    @staticmethod
    @abstractmethod
    def description() -> str:
        ...

    @abstractmethod
    def process_entries(self, entries: List[SRTEntry], **kwargs
                        ) -> List[Dict[str, Any]]:
        ...

    def batch_synthesize(self, entries: List[SRTEntry],
                         fixed_durations: bool = False, **kwargs):
        """Synthesize all entries in one bucketed batch when the engine
        supports it (in place of the reference's sequential per-entry
        loop); with ``fixed_durations``, each fixed to its entry's duration,
        where the engine's batch takes durations
        (``batch_duration_control``). Returns list of (audio, sr) or None
        on fallback."""
        if not kwargs.get("batched", True):
            return None
        fn = getattr(self.tts_engine, "synthesize_batch", None)
        if fn is None:
            return None
        if fixed_durations:
            if not getattr(self.tts_engine, "batch_duration_control", False):
                return None
            kwargs = {**kwargs, "durations": [e.duration for e in entries]}
        try:
            return fn([e.text for e in entries], **kwargs)
        except Exception:
            return None

    @staticmethod
    def make_segment(entry: SRTEntry, audio_data) -> Dict[str, Any]:
        return {"audio_data": audio_data, "start_time": entry.start_time,
                "end_time": entry.end_time, "text": entry.text,
                "index": entry.index, "duration": entry.duration}
