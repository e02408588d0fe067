"""F5-TTS engine adapter (spec: srt_dubbing/src/tts_engines/f5_tts_engine.py).

The external f5-tts package is optional; when absent the engine raises a
clear error at construction (same external-repo pattern as the reference).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from index_tts_dubbing_tpu_torch.dubbing.engines.base import BaseTTSEngine


class F5TTSEngine(BaseTTSEngine):
    def __init__(self, **init_kwargs):
        try:
            from f5_tts.api import F5TTS  # external, optional
        except ImportError as e:
            raise ImportError(
                "F5-TTS engine requires the external 'f5-tts' package "
                "(see the reference's F5TTS_infer.md for setup)") from e
        self.f5 = F5TTS(**init_kwargs)

    def synthesize(self, text: str, **kwargs) -> Tuple[np.ndarray, int]:
        voice_reference = kwargs.get("voice_reference")
        if not voice_reference:
            raise ValueError("voice_reference is required")
        wav, sr, _ = self.f5.infer(
            ref_file=voice_reference,
            ref_text=kwargs.get("ref_text", ""),
            gen_text=text,
            remove_silence=kwargs.get("remove_silence", False))
        return np.asarray(wav, np.float32), sr

    def synthesize_to_duration(self, text: str, target_duration: float,
                               **kwargs) -> Tuple[np.ndarray, int]:
        voice_reference = kwargs.get("voice_reference")
        if not voice_reference:
            raise ValueError("voice_reference is required")
        from index_tts_dubbing_tpu_torch.utils.audio import read_wav
        ref, ref_sr = read_wav(voice_reference)
        ref_dur = ref.shape[-1] / ref_sr
        wav, sr, _ = self.f5.infer(
            ref_file=voice_reference,
            ref_text=kwargs.get("ref_text", ""),
            gen_text=text,
            fix_duration=ref_dur + target_duration)
        return np.asarray(wav, np.float32), sr
