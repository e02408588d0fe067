"""TTS engine plugin registry (spec: srt_dubbing/src/tts_engines/__init__.py)."""
from __future__ import annotations

from typing import Dict, Type

from index_tts_dubbing_tpu_torch.dubbing.engines.base import BaseTTSEngine
from index_tts_dubbing_tpu_torch.dubbing.engines.index_tts import IndexTTSEngine
from index_tts_dubbing_tpu_torch.dubbing.engines.index_tts2 import IndexTTS2Engine
from index_tts_dubbing_tpu_torch.dubbing.engines.f5_tts import F5TTSEngine
from index_tts_dubbing_tpu_torch.dubbing.engines.cosyvoice import CosyVoiceEngine

TTS_ENGINES: Dict[str, Type[BaseTTSEngine]] = {
    "index_tts": IndexTTSEngine,
    "index_tts2": IndexTTS2Engine,
    "f5_tts": F5TTSEngine,
    "cosy_voice": CosyVoiceEngine,
}


def get_tts_engine(name: str, **kwargs) -> BaseTTSEngine:
    if name not in TTS_ENGINES:
        raise ValueError(f"unknown TTS engine: {name!r}; "
                         f"available: {sorted(TTS_ENGINES)}")
    return TTS_ENGINES[name](**kwargs)
