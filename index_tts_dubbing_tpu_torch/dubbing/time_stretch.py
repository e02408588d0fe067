"""Time-stretching DSP (librosa-free).

Spec: srt_dubbing/src/utils.py:240-282 ``time_stretch_hq`` — a 0.75/0.25
blend of (resample + pitch-shift) and a phase-vocoder time stretch. Both
building blocks are implemented here on numpy/scipy.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Optional

import numpy as np
from scipy import signal as sps


def _stft(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = y[idx] * win
    return np.fft.rfft(frames, axis=1).T  # (F, T)


def _istft(spec: np.ndarray, n_fft: int, hop: int,
           length: Optional[int] = None) -> np.ndarray:
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    frames = np.fft.irfft(spec.T, n=n_fft, axis=1) * win
    n_frames = frames.shape[0]
    out_len = n_fft + hop * (n_frames - 1)
    out = np.zeros(out_len, np.float64)
    norm = np.zeros(out_len, np.float64)
    w2 = win.astype(np.float64) ** 2
    for i in range(n_frames):
        s = i * hop
        out[s:s + n_fft] += frames[i]
        norm[s:s + n_fft] += w2
    out = out / np.maximum(norm, 1e-8)
    pad = n_fft // 2
    out = out[pad:]
    if length is not None:
        out = out[:length] if len(out) >= length else np.pad(
            out, (0, length - len(out)))
    else:
        out = out[: out_len - 2 * pad]
    return out.astype(np.float32)


def phase_vocoder(spec: np.ndarray, rate: float, hop: int) -> np.ndarray:
    """Standard phase vocoder over an STFT (F, T) → (F, ceil(T/rate))."""
    n_fft = 2 * (spec.shape[0] - 1)
    time_steps = np.arange(0, spec.shape[1], rate)
    phi_advance = np.linspace(0, np.pi * hop, spec.shape[0])
    out = np.zeros((spec.shape[0], len(time_steps)), complex)
    phase_acc = np.angle(spec[:, 0])
    padded = np.pad(spec, ((0, 0), (0, 2)))
    for t, step in enumerate(time_steps):
        i = int(step)
        frac = step - i
        s1 = padded[:, i]
        s2 = padded[:, i + 1]
        mag = (1 - frac) * np.abs(s1) + frac * np.abs(s2)
        out[:, t] = mag * np.exp(1j * phase_acc)
        dphase = np.angle(s2) - np.angle(s1) - phi_advance
        dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase_acc += phi_advance + dphase
    return out


def time_stretch(y: np.ndarray, rate: float, hop_length: int = 512,
                 n_fft: int = 2048) -> np.ndarray:
    """Phase-vocoder time stretch; rate>1 speeds up (librosa semantics)."""
    if rate == 1.0:
        return y
    spec = _stft(y, n_fft, hop_length)
    stretched = phase_vocoder(spec, rate, hop_length)
    n_out = int(round(len(y) / rate))
    return _istft(stretched, n_fft, hop_length, length=n_out)


def resample(y: np.ndarray, orig_sr: float, target_sr: float) -> np.ndarray:
    frac = Fraction(target_sr / orig_sr).limit_denominator(1000)
    return sps.resample_poly(y, frac.numerator, frac.denominator
                             ).astype(np.float32)


def pitch_shift(y: np.ndarray, sr: int, n_steps: float) -> np.ndarray:
    """librosa.effects.pitch_shift semantics: shift pitch, keep duration."""
    rate = 2.0 ** (-n_steps / 12.0)
    stretched = time_stretch(y, rate)
    out = resample(stretched, sr / rate, sr)
    if len(out) >= len(y):
        return out[: len(y)]
    return np.pad(out, (0, len(y) - len(out)))


def fix_length(y: np.ndarray, size: int) -> np.ndarray:
    if len(y) >= size:
        return y[:size]
    return np.pad(y, (0, size - len(y)))


def time_stretch_hq(y: np.ndarray, rate: float, sr: int) -> np.ndarray:
    """Hybrid high-quality stretch (0.75·resample+pitch-fix +
    0.25·phase-vocoder), matching utils.py:240-282."""
    if rate == 1.0:
        return y
    y = np.asarray(y, np.float32)
    y_resampled = resample(y, sr * rate, sr)
    n_steps = 12.0 * np.log2(rate)
    y_hq = pitch_shift(y_resampled, sr, -n_steps)
    y_standard = time_stretch(y, rate=rate, hop_length=512, n_fft=2048)
    y_standard = fix_length(y_standard, len(y_hq))
    return (0.75 * y_hq + 0.25 * y_standard).astype(np.float32)
