"""Speaker-similarity scoring: cosine similarity between speaker embeddings
of two waveforms.

Counterpart of the JAX package's ``eval/speaker_sim.py``. The reference
publishes SS numbers computed with an external speaker-verification model;
this scorer uses the port's own ECAPA-TDNN (the vocoder's conditioning
encoder, models/ecapa.py) over the same 24 kHz mel front end, so it needs
no external checkpoint. A different embedder can be passed as
``embed_fn``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from index_tts_dubbing_tpu_torch.models import ecapa
from index_tts_dubbing_tpu_torch.ops.mel import MelSpectrogram
from index_tts_dubbing_tpu_torch.utils.audio import resample


def make_ecapa_embedder(ecapa_params, mel_fn: Optional[MelSpectrogram] = None
                        ) -> Callable[[np.ndarray, int], np.ndarray]:
    """Returns embed(wav_float32, sr) -> (D,) unit-norm float32 embedding,
    computed on the device of ``ecapa_params`` (the mel on ``mel_fn``'s;
    by default a 24 kHz MelSpectrogram on the parameters' device)."""
    device = ecapa_params["fc"]["w"].device
    mel_fn = mel_fn or MelSpectrogram(device=device)

    def embed(wav: np.ndarray, sr: int) -> np.ndarray:
        wav = np.asarray(wav, np.float32).reshape(-1)
        if sr != mel_fn.sample_rate:
            wav = resample(wav, sr, mel_fn.sample_rate)
        mel = mel_fn(wav)                              # (1, n_mels, T)
        with torch.no_grad():
            emb = ecapa.forward(ecapa_params, mel.transpose(1, 2).to(device))
        emb = emb.float().cpu().numpy().reshape(-1)
        return emb / max(float(np.linalg.norm(emb)), 1e-9)

    return embed


def speaker_similarity(wav_a: np.ndarray, sr_a: int, wav_b: np.ndarray,
                       sr_b: int, embed_fn: Callable) -> float:
    """Cosine similarity in [-1, 1] between the two waveforms' speaker
    embeddings."""
    ea = embed_fn(wav_a, sr_a)
    eb = embed_fn(wav_b, sr_b)
    return float(np.dot(ea, eb))
