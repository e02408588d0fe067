"""Adaptive strategy: delegate duration targeting to the engine
(spec: srt_dubbing/src/strategies/adaptive_strategy.py); raises when the
engine can't control duration. An engine whose batch takes durations
voices every entry at its duration in batched calls; else one entry at a
time through ``synthesize_to_duration``."""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from index_tts_dubbing_tpu_torch.dubbing.config import AUDIO, LOG
from index_tts_dubbing_tpu_torch.dubbing.logger import (create_process_logger,
                                                  get_logger)
from index_tts_dubbing_tpu_torch.dubbing.srt_parser import SRTEntry
from index_tts_dubbing_tpu_torch.dubbing.strategies.base import TimeSyncStrategy


class AdaptiveStrategy(TimeSyncStrategy):
    @staticmethod
    def name() -> str:
        return "adaptive"

    @staticmethod
    def description() -> str:
        return "engine-native duration-targeted synthesis"

    def process_entries(self, entries: List[SRTEntry], **kwargs
                        ) -> List[Dict[str, Any]]:
        log = get_logger()
        if not kwargs.get("voice_reference"):
            raise ValueError("voice_reference is required")
        assert self.tts_engine is not None, "no TTS engine injected"
        if not self.tts_engine.supports_duration_control:
            raise ValueError(
                f"engine {type(self.tts_engine).__name__} does not support "
                "duration-targeted synthesis; use another strategy")
        proc = create_process_logger("adaptive strategy synthesis")
        proc.start(f"{len(entries)} entries")
        batch = self.batch_synthesize(entries, fixed_durations=True,
                                      **kwargs)
        segments: List[Dict[str, Any]] = []
        for i, entry in enumerate(entries):
            preview = entry.text[:LOG.PROGRESS_TEXT_PREVIEW_LENGTH]
            proc.progress(i + 1, len(entries), f"entry {entry.index}: {preview}")
            try:
                if batch is not None:
                    audio, sr = batch[i]
                else:
                    audio, sr = self.tts_engine.synthesize_to_duration(
                        entry.text, entry.duration, **kwargs)
                segments.append(self.make_segment(entry, audio))
            except Exception as e:
                log.error(f"entry {entry.index} failed: {e}")
                silence = np.zeros(int(entry.duration
                                       * AUDIO.DEFAULT_SAMPLE_RATE), np.float32)
                segments.append(self.make_segment(entry, silence))
        proc.complete(f"{len(segments)} segments")
        return segments
