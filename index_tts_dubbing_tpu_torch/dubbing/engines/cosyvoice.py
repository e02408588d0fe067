"""CosyVoice engine adapter (spec: srt_dubbing/src/tts_engines/
cosy_voice_engine.py). External CosyVoice package is optional."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from index_tts_dubbing_tpu_torch.dubbing.engines.base import BaseTTSEngine


class CosyVoiceEngine(BaseTTSEngine):
    def __init__(self, model_dir: str = "model-dir/cosyvoice", **kw):
        try:
            from cosyvoice.cli.cosyvoice import CosyVoice2  # external
        except ImportError as e:
            raise ImportError(
                "CosyVoice engine requires the external 'cosyvoice' package "
                "(see the reference's cosyvoice_infer.md for setup)") from e
        self.model = CosyVoice2(model_dir, **kw)
        self.sample_rate = getattr(self.model, "sample_rate", 24000)

    def synthesize(self, text: str, **kwargs) -> Tuple[np.ndarray, int]:
        voice_reference = kwargs.get("voice_reference")
        if not voice_reference:
            raise ValueError("voice_reference is required")
        from index_tts_dubbing_tpu_torch.utils.audio import load_audio
        prompt = load_audio(voice_reference, 16000)[0]
        chunks = []
        for out in self.model.inference_zero_shot(
                text, kwargs.get("prompt_text", ""), prompt,
                stream=False):
            chunks.append(np.asarray(out["tts_speech"]).reshape(-1))
        wav = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        return wav.astype(np.float32), self.sample_rate
