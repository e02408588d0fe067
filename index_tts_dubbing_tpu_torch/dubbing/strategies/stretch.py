"""Stretch strategy: synthesize naturally, then time-stretch to the subtitle
duration (spec: srt_dubbing/src/strategies/stretch_strategy.py): rate =
source/target, clamped to [0.7, 1.5]; pad silence when short; keep full audio
(allow overlap) when long."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from index_tts_dubbing_tpu_torch.dubbing.config import AUDIO, LOG, STRATEGY
from index_tts_dubbing_tpu_torch.dubbing.logger import (create_process_logger,
                                                  get_logger)
from index_tts_dubbing_tpu_torch.dubbing.srt_parser import SRTEntry
from index_tts_dubbing_tpu_torch.dubbing.strategies.base import TimeSyncStrategy
from index_tts_dubbing_tpu_torch.dubbing.time_stretch import time_stretch_hq


class StretchStrategy(TimeSyncStrategy):
    max_default = STRATEGY.MAX_SPEED_RATIO
    min_default = STRATEGY.MIN_SPEED_RATIO

    def __init__(self, tts_engine=None, max_speed_ratio: Optional[float] = None,
                 min_speed_ratio: Optional[float] = None):
        super().__init__(tts_engine)
        self.max_speed_ratio = max_speed_ratio or self.max_default
        self.min_speed_ratio = min_speed_ratio or self.min_default

    @staticmethod
    def name() -> str:
        return "stretch"

    @staticmethod
    def description() -> str:
        return "time-stretch synthesis to match subtitle durations"

    def _quality_check(self, entry: SRTEntry, rate: float) -> None:
        pass  # hq subclass overrides with risk warnings

    def process_entries(self, entries: List[SRTEntry], **kwargs
                        ) -> List[Dict[str, Any]]:
        log = get_logger()
        if not kwargs.get("voice_reference"):
            raise ValueError("voice_reference is required")
        verbose = kwargs.get("verbose", False)
        proc = create_process_logger("stretch strategy synthesis")
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
                src_dur = len(audio) / sr
                tgt_dur = entry.duration
                rate = 1.0 if tgt_dur == 0 else src_dur / tgt_dur
                if abs(rate - 1.0) > STRATEGY.TIME_STRETCH_THRESHOLD:
                    clamped = float(np.clip(rate, self.min_speed_ratio,
                                            self.max_speed_ratio))
                    if abs(clamped - rate) > 0.01:
                        log.warning(
                            f"entry {entry.index}: rate {rate:.2f} outside "
                            f"safe range, clamped to {clamped:.2f}")
                    self._quality_check(entry, clamped)
                    audio = time_stretch_hq(audio, rate=clamped, sr=sr)
                    target_samples = int(tgt_dur * sr)
                    if 0 < len(audio) < target_samples:
                        audio = np.concatenate(
                            [audio, np.zeros(target_samples - len(audio),
                                             np.float32)])
                    # longer than target: keep full audio (overlap allowed)
                segments.append(self.make_segment(entry, audio))
            except Exception as e:
                log.error(f"entry {entry.index} failed: {e}")
                silence = np.zeros(int(entry.duration
                                       * AUDIO.DEFAULT_SAMPLE_RATE), np.float32)
                segments.append(self.make_segment(entry, silence))
        proc.complete(f"{len(segments)} segments")
        return segments
