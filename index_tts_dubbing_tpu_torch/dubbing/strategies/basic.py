"""Basic strategy: one natural synthesis per entry, no time adjustment
(spec: srt_dubbing/src/strategies/basic_strategy.py). Per-entry failure →
silence of the entry's duration (the reference's graceful-degradation
ladder, basic_strategy.py:86-97)."""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from index_tts_dubbing_tpu_torch.dubbing.config import AUDIO, LOG
from index_tts_dubbing_tpu_torch.dubbing.logger import (create_process_logger,
                                                  get_logger)
from index_tts_dubbing_tpu_torch.dubbing.srt_parser import SRTEntry
from index_tts_dubbing_tpu_torch.dubbing.strategies.base import TimeSyncStrategy


class BasicStrategy(TimeSyncStrategy):
    @staticmethod
    def name() -> str:
        return "basic"

    @staticmethod
    def description() -> str:
        return "natural synthesis per entry, no time adjustment"

    def process_entries(self, entries: List[SRTEntry], **kwargs
                        ) -> List[Dict[str, Any]]:
        log = get_logger()
        if not kwargs.get("voice_reference"):
            raise ValueError("voice_reference is required")
        proc = create_process_logger("basic strategy synthesis")
        proc.start(f"{len(entries)} entries")
        batch = self.batch_synthesize(entries, **kwargs)
        segments: List[Dict[str, Any]] = []
        for i, entry in enumerate(entries):
            preview = entry.text[:LOG.PROGRESS_TEXT_PREVIEW_LENGTH]
            proc.progress(i + 1, len(entries), f"entry {entry.index}: {preview}")
            try:
                assert self.tts_engine is not None, "no TTS engine injected"
                if batch is not None:
                    audio, sr = batch[i]
                else:
                    audio, sr = self.tts_engine.synthesize(entry.text, **kwargs)
                segments.append(self.make_segment(entry, audio))
            except Exception as e:
                log.error(f"entry {entry.index} failed: {e}")
                silence = np.zeros(int(entry.duration
                                       * AUDIO.DEFAULT_SAMPLE_RATE), np.float32)
                segments.append(self.make_segment(entry, silence))
        proc.complete(f"{len(segments)} segments")
        return segments
