"""IndexTTS engine adapter for the dubbing layer, on the port's engine.

Spec: srt_dubbing/src/tts_engines/index_tts_engine.py — wraps
IndexTTS.infer(output_path=None), int16→float32 normalisation, and
duration-targeted synthesis. The reference's duration control bisects HF beam
``length_penalty`` (≤5 full re-syntheses, index_tts_engine.py:70-107); this
adapter, as the JAX package's, samples the candidates in one batched decode
instead (see ``synthesize_to_duration``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from index_tts_dubbing_tpu_torch.dubbing.config import AUDIO, IndexTTSConfig
from index_tts_dubbing_tpu_torch.dubbing.engines.base import BaseTTSEngine
from index_tts_dubbing_tpu_torch.dubbing.logger import get_logger


class IndexTTSEngine(BaseTTSEngine):
    _INFER_KWARGS = {"do_sample", "top_p", "top_k", "temperature",
                     "repetition_penalty", "max_mel_tokens",
                     "max_text_tokens_per_sentence", "num_beams",
                     "length_penalty", "typical_sampling", "typical_mass",
                     "verbose"}

    def __init__(self, engine=None, **init_kwargs):
        from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS
        if engine is not None:
            self.tts = engine
        else:
            kwargs = {**IndexTTSConfig.get_init_kwargs(), **init_kwargs}
            self.tts = IndexTTS(**kwargs)

    def _filter_kwargs(self, kwargs):
        return {k: v for k, v in kwargs.items() if k in self._INFER_KWARGS}

    def synthesize(self, text: str, **kwargs) -> Tuple[np.ndarray, int]:
        voice_reference = kwargs.get("voice_reference")
        if not voice_reference:
            raise ValueError("voice_reference is required")
        sr, wav = self.tts.infer(voice_reference, text, None,
                                 **self._filter_kwargs(kwargs))
        audio = wav.flatten().astype(np.float32) / AUDIO.AUDIO_NORMALIZATION_FACTOR
        return audio, sr

    def synthesize_batch(self, texts, **kwargs):
        """Batched synthesis across SRT entries: one ``infer_batch`` call
        (one bucketed decode on the card) instead of per-entry sequential
        inference."""
        voice_reference = kwargs.get("voice_reference")
        if not voice_reference:
            raise ValueError("voice_reference is required")
        outs = self.tts.infer_batch(voice_reference, list(texts),
                                    **self._filter_kwargs(kwargs))
        return [(wav.flatten().astype(np.float32)
                 / AUDIO.AUDIO_NORMALIZATION_FACTOR, sr)
                for sr, wav in outs]

    def synthesize_to_duration(self, text: str, target_duration: float,
                               n_candidates: int = 4, tolerance: float = 0.1,
                               **kwargs) -> Tuple[np.ndarray, int]:
        """Duration-targeted synthesis WITHOUT truncation.

        The reference bisects HF ``length_penalty`` with up to 5 sequential
        full re-syntheses (index_tts_engine.py:70-107). Here the re-tries are
        a single BATCHED decode: ``n_candidates`` rows of the same text in one
        ``infer_batch`` call, plus the natural first attempt; the candidate
        whose duration is nearest the target wins. With sampling (the
        engine's default) the rows are distinct samples: the batched decode
        draws every row's noise from the engine's one generator. Every
        candidate runs to its own stop token — the adapter adds no
        ``max_mel_tokens`` cut."""
        log = get_logger()
        audio, sr = self.synthesize(text, **kwargs)
        dur = len(audio) / sr
        if abs(dur - target_duration) <= tolerance or n_candidates <= 1:
            return audio, sr
        log.debug(f"duration miss ({dur:.2f}s vs {target_duration:.2f}s); "
                  f"sampling {n_candidates} batched candidates")
        cands = [(audio, sr)]
        cands += self.synthesize_batch([text] * n_candidates, **kwargs)
        best = min(cands,
                   key=lambda c: abs(len(c[0]) / c[1] - target_duration))
        best_dur = len(best[0]) / best[1]
        log.debug(f"picked candidate at {best_dur:.2f}s "
                  f"(target {target_duration:.2f}s)")
        return best
