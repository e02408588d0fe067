"""Audio segment merging and export (spec: srt_dubbing/src/audio_processor.py).

Two merge modes, matching the reference exactly:
- natural concatenation (index order) for basic/hq_stretch/adaptive/iterative
  strategies (audio_processor.py:70-131);
- time-synchronized placement (zero buffer, overlap push-back, dynamic
  growth, peak normalisation) for stretch (audio_processor.py:133-230).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from index_tts_dubbing_tpu_torch.dubbing.config import AUDIO
from index_tts_dubbing_tpu_torch.dubbing.logger import get_logger
from index_tts_dubbing_tpu_torch.utils import audio as audio_util


class AudioProcessor:
    def __init__(self, sample_rate: Optional[int] = None,
                 channels: Optional[int] = None):
        self.sample_rate = sample_rate or AUDIO.DEFAULT_SAMPLE_RATE
        self.channels = channels or AUDIO.DEFAULT_CHANNELS
        self.audio_segments: List[Dict[str, Any]] = []

    def merge_audio_segments(self, segments: List[Dict[str, Any]],
                             strategy_name: str = "stretch",
                             truncate_on_overflow: bool = False,
                             verbose: bool = False) -> np.ndarray:
        if not segments:
            return np.array([])
        if strategy_name in ("basic", "hq_stretch", "iterative", "adaptive"):
            return self._natural_concatenation(segments, verbose)
        return self._time_synchronized_merge(segments, truncate_on_overflow,
                                             verbose)

    def _natural_concatenation(self, segments: List[Dict[str, Any]],
                               verbose: bool = False) -> np.ndarray:
        log = get_logger()
        parts = []
        for seg in sorted(segments, key=lambda x: x.get("index", 0)):
            data = np.asarray(seg["audio_data"], np.float32)
            if data.size == 0:
                log.warning(f"segment {seg.get('index', '?')} is empty; skipped")
                continue
            parts.append(data)
        if not parts:
            log.warning("no valid audio to concatenate")
            return np.array([])
        return np.concatenate(parts)

    def _time_synchronized_merge(self, segments: List[Dict[str, Any]],
                                 truncate_on_overflow: bool,
                                 verbose: bool) -> np.ndarray:
        log = get_logger()
        sr = self.sample_rate
        segs = sorted(segments, key=lambda x: x["start_time"])
        max_end = 0.0
        for seg in segs:
            data = seg["audio_data"]
            if hasattr(data, "__len__") and len(data) > 0:
                max_end = max(max_end, seg["start_time"] + len(data) / sr)
            else:
                max_end = max(max_end, seg.get("end_time", seg["start_time"]))
        total = int(max_end * sr) + AUDIO.DYNAMIC_BUFFER_SIZE
        out = np.zeros(total, np.float32)
        prev_end_sample = None
        for i, seg in enumerate(segs):
            data = np.asarray(seg["audio_data"], np.float32)
            if data.size == 0:
                continue
            start = int(seg["start_time"] * sr)
            end = start + data.size
            if not truncate_on_overflow and i > 0 and prev_end_sample is not None:
                if start < prev_end_sample:
                    log.warning(
                        f"segment {i + 1} overlaps previous by "
                        f"{(prev_end_sample - start) / sr:.2f}s; pushed back")
                    start = prev_end_sample
                    end = start + data.size
            if end > total:
                new_total = end + AUDIO.DYNAMIC_BUFFER_SIZE
                grown = np.zeros(new_total, np.float32)
                grown[: out.size] = out
                out = grown
                total = new_total
            out[start:end] += data
            prev_end_sample = end
        if not truncate_on_overflow:
            peak = float(np.max(np.abs(out))) if out.size else 0.0
            if peak > AUDIO.MAX_AMPLITUDE:
                out = out / peak
        return out

    def resample_audio(self, audio_data: np.ndarray, source_rate: int,
                       target_rate: int) -> np.ndarray:
        """Linear-interp resample (audio_processor.py:281-305 semantics)."""
        if source_rate == target_rate:
            return audio_data
        ratio = target_rate / source_rate
        new_len = int(len(audio_data) * ratio)
        old_idx = np.linspace(0, len(audio_data) - 1, new_len)
        return np.interp(old_idx, np.arange(len(audio_data)),
                         audio_data).astype(np.float32)

    def export_audio(self, audio_data: np.ndarray, output_path: str,
                     format: str = "wav") -> bool:
        log = get_logger()
        try:
            if len(audio_data) > 0:
                peak = float(np.max(np.abs(audio_data)))
                if peak > AUDIO.MAX_AMPLITUDE:
                    audio_data = audio_data / peak
            audio_util.write_wav(output_path, audio_data, self.sample_rate)
            log.success(f"audio exported to {output_path}")
            return True
        except Exception as e:
            log.error(f"audio export failed: {e}")
            return False

    def load_audio(self, file_path: str) -> np.ndarray:
        data, sr = audio_util.read_wav(file_path)
        mono = data.mean(axis=0) if data.shape[0] > 1 else data[0]
        if sr != self.sample_rate:
            mono = self.resample_audio(mono, sr, self.sample_rate)
        return mono
