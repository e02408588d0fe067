"""IndexTTS-2 engine adapter for the dubbing layer, on the port's engine
(``engine/indextts2.IndexTTS2``).

``synthesize`` voices one line with IndexTTS-2's defaults;
``synthesize_batch`` voices many lines in ``infer_batch`` calls of
``lines_per_batch`` lines (one batch of beam rows and one S2M batch on the
card each); ``synthesize_to_duration`` caps the line's semantic codes at
the target's ``CODES_PER_SECOND`` (50 a second): a line that runs to its
cap lasts the target to the mel hop, one that stops earlier is shorter, and
nothing is cut. Each needs ``voice_reference`` and takes IndexTTS-2's
generation settings (``engine/indextts2.GENERATION``) and ``seed`` (the
S2M noise's).

The engine needs IndexTTS-2's weights, as ``params`` (the port's tree,
``weights.indextts2_tree``'s layout) or a built ``engine``, and refuses to
build without them: the port has no loader of the published checkpoints
yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from index_tts_dubbing_tpu_torch.dubbing.config import AUDIO
from index_tts_dubbing_tpu_torch.dubbing.engines.base import BaseTTSEngine
from index_tts_dubbing_tpu_torch.engine.indextts2 import GENERATION, IndexTTS2

CODES_PER_SECOND = 50


class IndexTTS2Engine(BaseTTSEngine):
    # a scene a call: 16 lines are 48 beam rows at 3 beams
    lines_per_batch = 16

    def __init__(self, engine=None, params: Optional[Dict[str, Any]] = None,
                 **init_kwargs):
        if engine is None:
            if params is None:
                raise ValueError(
                    "the index_tts2 engine needs IndexTTS-2's weights: pass "
                    "params= (the port's tree) or engine=; the port has no "
                    "loader of the published checkpoints yet")
            engine = IndexTTS2(params=params, **init_kwargs)
        self.tts = engine

    @staticmethod
    def _voice(kwargs) -> str:
        voice_reference = kwargs.get("voice_reference")
        if not voice_reference:
            raise ValueError("voice_reference is required")
        return voice_reference

    @staticmethod
    def _call(kwargs) -> Dict[str, Any]:
        """The keyword arguments the engine takes of the strategy's."""
        return {k: kwargs[k] for k in set(GENERATION) | {"seed"}
                if k in kwargs}

    @staticmethod
    def _float(out) -> Tuple[np.ndarray, int]:
        sr, wav = out
        return (wav.flatten().astype(np.float32)
                / AUDIO.AUDIO_NORMALIZATION_FACTOR, sr)

    def synthesize(self, text: str, **kwargs) -> Tuple[np.ndarray, int]:
        return self._float(self.tts.infer(self._voice(kwargs), text,
                                          **self._call(kwargs)))

    def synthesize_batch(self, texts: Sequence[str], **kwargs
                         ) -> List[Tuple[np.ndarray, int]]:
        texts, call = list(texts), self._call(kwargs)
        outs: List[Tuple[np.ndarray, int]] = []
        for lo in range(0, len(texts), self.lines_per_batch):
            outs += [self._float(o) for o in self.tts.infer_batch(
                self._voice(kwargs), texts[lo: lo + self.lines_per_batch],
                **call)]
        return outs

    def synthesize_to_duration(self, text: str, target_duration: float,
                               **kwargs) -> Tuple[np.ndarray, int]:
        call = dict(self._call(kwargs), max_mel_tokens=max(
            1, int(round(target_duration * CODES_PER_SECOND))))
        return self._float(self.tts.infer(self._voice(kwargs), text, **call))
