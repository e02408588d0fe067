"""Log-mel frontends.

``MelSpectrogram``: IndexTTS's, numerically matching the JAX package's
``ops/mel.py`` (the reference's torchaudio pipeline): 24 kHz, n_fft 1024,
hop 256, win 1024, periodic hann, centre reflect pad, magnitude, HTK mel
scale with no filterbank norm, then log(clip(·, 1e-7)).

``BigVGANMel``: BigVGAN's (``get_mel_spectrogram``, which F5-TTS's
``mel_spec_type="bigvgan"`` uses): reflect pad of (n_fft - hop)/2 on each
side with no centring, periodic hann, magnitude sqrt(re² + im² + 1e-9),
librosa's slaney-scale filterbank with slaney norm, then log(clamp(·,
1e-5))."""
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


def hz_to_mel_slaney(f):
    """librosa's default (slaney) mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = math.log(6.4) / 27.0
    lin = f / f_sp
    log = min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log, lin)


def mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def slaney_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                      f_min: float = 0.0, f_max: float | None = None
                      ) -> np.ndarray:
    """``librosa.filters.mel`` at its defaults (slaney scale, slaney norm):
    (n_mels, n_fft // 2 + 1)."""
    f_max = sample_rate / 2.0 if f_max is None else f_max
    fft_f = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_f = mel_to_hz_slaney(np.linspace(hz_to_mel_slaney(f_min),
                                         hz_to_mel_slaney(f_max), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.astype(np.float32)


class BigVGANMel:
    """BigVGAN's log-mel (module docstring); window and filterbank live on
    ``device``."""

    def __init__(self, sample_rate: int = 24000, n_fft: int = 1024,
                 hop_length: int = 256, win_length: int = 1024,
                 n_mels: int = 100, f_min: float = 0.0,
                 f_max: float | None = None, device="cuda"):
        self.n_fft, self.hop_length = n_fft, hop_length
        win = hann_window(win_length)
        if win_length < n_fft:
            lpad = (n_fft - win_length) // 2
            win = np.pad(win, (lpad, n_fft - win_length - lpad))
        self.window = torch.as_tensor(win, device=device)
        self.fbank = torch.as_tensor(
            slaney_filterbank(sample_rate, n_fft, n_mels, f_min, f_max),
            device=device)

    def frames(self, samples: int) -> int:
        """Mel frames of a wav of ``samples`` samples."""
        return (samples + 2 * ((self.n_fft - self.hop_length) // 2)
                - self.n_fft) // self.hop_length + 1

    def __call__(self, audio) -> torch.Tensor:
        """audio (B, T) or (T,) → log-mel (B, n_mels, frames), float32."""
        audio = torch.as_tensor(audio, device=self.window.device).float()
        if audio.ndim == 1:
            audio = audio[None, :]
        p = (self.n_fft - self.hop_length) // 2
        audio = F.pad(audio[:, None], (p, p), mode="reflect")[:, 0]
        frames = audio.unfold(-1, self.n_fft, self.hop_length)
        spec = torch.fft.rfft(frames * self.window, dim=-1)
        mag = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-9)
        mel = torch.einsum("btf,mf->bmt", mag, self.fbank)
        return torch.log(torch.clamp(mel, min=1e-5))
