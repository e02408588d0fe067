"""Self-contained audio IO + resampling (no torchaudio/librosa/soundfile).

Covers the reference capabilities of utils/common.py:11-26 (load_audio:
load→mono→resample→clip) and torchaudio.save of int16 wavs (infer.py:653),
using only the stdlib ``wave`` module, numpy and scipy.
"""
from __future__ import annotations

import math
import wave
from pathlib import Path
from typing import Tuple

import numpy as np
from scipy import signal as sps


def read_wav(path) -> Tuple[np.ndarray, int]:
    """Read a PCM wav file. Returns (float32 samples in [-1,1], shape (C, T)),
    sample_rate."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        b = (a[:, 0].astype(np.int32) | (a[:, 1].astype(np.int32) << 8)
             | (a[:, 2].astype(np.int32) << 16))
        b = np.where(b >= 1 << 23, b - (1 << 24), b)
        data = b.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported sample width: {width}")
    data = data.reshape(-1, ch).T  # (C, T)
    return np.ascontiguousarray(data), sr


def write_wav(path, audio: np.ndarray, sample_rate: int) -> None:
    """Write int16 PCM wav. ``audio``: float in [-1,1] or int16, (T,), (C,T)."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    if audio.dtype != np.int16:
        audio = np.clip(audio, -1.0, 1.0)
        audio = (audio * 32767.0).astype(np.int16)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(audio.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(audio.T.tobytes())


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling with a kaiser-windowed sinc (equivalent quality to
    torchaudio.functional.resample's windowed-sinc path)."""
    if orig_sr == target_sr:
        return audio
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return sps.resample_poly(audio, up, down, axis=-1).astype(np.float32)


def load_audio(path, sampling_rate: int) -> np.ndarray:
    """Load wav → mono (first channel) → resample → clip. Mirrors the
    reference's utils/common.py:11-26 load_audio semantics. Returns (1, T)."""
    audio, sr = read_wav(path)
    if audio.shape[0] > 1:
        audio = audio[:1]
    audio = resample(audio, sr, sampling_rate)
    return np.clip(audio, -1.0, 1.0)


def load_audio_mean_mono(path, sampling_rate: int) -> np.ndarray:
    """Load wav → channel-mean mono → resample. Mirrors infer.py:509-513
    (torch.mean over channels before resampling). Returns (1, T)."""
    audio, sr = read_wav(path)
    audio = audio.mean(axis=0, keepdims=True)
    return resample(audio, sr, sampling_rate)
