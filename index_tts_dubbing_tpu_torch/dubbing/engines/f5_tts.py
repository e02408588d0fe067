"""F5-TTS engine adapter for the dubbing layer, on the port's engine
(``engine/f5.F5TTS``; spec: srt_dubbing/src/tts_engines/f5_tts_engine.py).

``synthesize`` lets F5 estimate the duration from the texts;
``synthesize_to_duration`` fixes the line's duration, as the reference
passes ``fix_duration = prompt + target`` (the result has exactly the
target's frames); ``synthesize_batch`` voices many lines in batched calls
of ``lines_per_batch`` lines, each fixed to its duration where
``durations`` gives one (the adaptive strategy's route). Each needs
``voice_reference`` and takes ``ref_text``, the prompt's transcript,
``seed`` and F5's sampler settings (``nfe_step``, ``cfg_strength``,
``sway_sampling_coef``).

The engine needs F5-TTS's weights, as ``params`` (the port's {"dit",
"vocoder"} tree, ``weights.init_f5``'s layout) or a built ``engine``, and
refuses to build without them: the port has no loader of the published
F5TTS_Base checkpoint yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from index_tts_dubbing_tpu_torch.dubbing.config import AUDIO
from index_tts_dubbing_tpu_torch.dubbing.engines.base import BaseTTSEngine
from index_tts_dubbing_tpu_torch.engine.f5 import SAMPLER_KEYS, F5TTS


class F5TTSEngine(BaseTTSEngine):
    batch_duration_control = True
    # a scene a call: 32 guided rows, padded to the longest line
    lines_per_batch = 16

    def __init__(self, engine=None, params: Optional[Dict[str, Any]] = None,
                 **init_kwargs):
        if engine is None:
            if params is None:
                raise ValueError(
                    "the f5_tts engine needs F5-TTS's weights: pass params= "
                    "(the port's {'dit', 'vocoder'} tree) or engine=; the "
                    "port has no loader of the published F5TTS_Base "
                    "checkpoint yet")
            engine = F5TTS(params=params, **init_kwargs)
        self.tts = engine

    @staticmethod
    def _voice(kwargs) -> str:
        voice_reference = kwargs.get("voice_reference")
        if not voice_reference:
            raise ValueError("voice_reference is required")
        return voice_reference

    @staticmethod
    def _call(kwargs):
        """The keyword arguments the engine takes of the strategy's."""
        return {k: kwargs[k] for k in SAMPLER_KEYS | {"seed"} if k in kwargs}

    @staticmethod
    def _float(out) -> Tuple[np.ndarray, int]:
        sr, wav = out
        return (wav.flatten().astype(np.float32)
                / AUDIO.AUDIO_NORMALIZATION_FACTOR, sr)

    def synthesize(self, text: str, **kwargs) -> Tuple[np.ndarray, int]:
        return self._float(self.tts.infer(
            self._voice(kwargs), kwargs.get("ref_text", ""), text,
            **self._call(kwargs)))

    def synthesize_batch(self, texts: Sequence[str],
                         durations: Optional[Sequence[Optional[float]]] = None,
                         **kwargs) -> List[Tuple[np.ndarray, int]]:
        """The lines in ``infer_batch`` calls of ``lines_per_batch`` lines
        (one batch of rows on the card each); ``durations``: each line's
        seconds (None: F5's estimate). With ``seed``, line i's noise is
        seed + i's whatever call serves it."""
        texts = list(texts)
        if durations is None:
            durations = [None] * len(texts)
        call = self._call(kwargs)
        outs: List[Tuple[np.ndarray, int]] = []
        for lo in range(0, len(texts), self.lines_per_batch):
            hi = lo + self.lines_per_batch
            if call.get("seed") is not None:
                call["seed"] = kwargs["seed"] + lo
            outs += [self._float(o) for o in self.tts.infer_batch(
                self._voice(kwargs), kwargs.get("ref_text", ""),
                texts[lo:hi], list(durations[lo:hi]), **call)]
        return outs

    def synthesize_to_duration(self, text: str, target_duration: float,
                               **kwargs) -> Tuple[np.ndarray, int]:
        return self._float(self.tts.infer(
            self._voice(kwargs), kwargs.get("ref_text", ""), text,
            seconds=target_duration, **self._call(kwargs)))
