"""Log-mel frontend, a frozen copy of the port's ``ops/mel.py``
(the reference's torchaudio pipeline): 24 kHz, n_fft 1024, hop 256, win
1024, periodic hann, centre reflect pad, magnitude, HTK mel scale with no
filterbank norm, then log(clip(·, 1e-7))."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic hann, same as torch.hann_window(periodic=True)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)).astype(np.float32)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: float | None = None) -> np.ndarray:
    """Triangular HTK-scale filterbank, norm=None. Returns (n_freqs, n_mels)."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


class MelSpectrogram:
    """Callable log-mel extractor; window and filterbank live on ``device``."""

    def __init__(self, sample_rate: int = 24000, n_fft: int = 1024,
                 hop_length: int = 256, win_length: int | None = None,
                 n_mels: int = 100, f_min: float = 0.0,
                 f_max: float | None = None, center: bool = True,
                 device="cuda"):
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length or n_fft
        self.center = center
        win = hann_window(self.win_length)
        if self.win_length < n_fft:
            lpad = (n_fft - self.win_length) // 2
            win = np.pad(win, (lpad, n_fft - self.win_length - lpad))
        self.window = torch.as_tensor(win, device=device)
        self.fbank = torch.as_tensor(
            mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max),
            device=device)

    def spectrogram(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (B, T) → magnitude spectrogram (B, F, frames)."""
        if self.center:
            p = self.n_fft // 2
            audio = F.pad(audio[:, None], (p, p), mode="reflect")[:, 0]
        frames = audio.unfold(-1, self.n_fft, self.hop_length)  # (B, fr, n_fft)
        spec = torch.fft.rfft((frames * self.window).float(), dim=-1)
        return spec.abs().transpose(1, 2)

    def __call__(self, audio) -> torch.Tensor:
        """audio (B, T) or (T,) → log-mel (B, n_mels, frames)."""
        audio = torch.as_tensor(audio, device=self.window.device)
        if audio.ndim == 1:
            audio = audio[None, :]
        mel = torch.einsum("bft,fm->bmt", self.spectrogram(audio), self.fbank)
        return torch.log(torch.clamp(mel, min=1e-7))
