"""IndexTTS-2's 16 kHz front-end features in plain PyTorch: the resampler
to 16 kHz and the two Kaldi-style filterbanks its speech models read.

- ``resample``: torchaudio's ``Resample`` (``sinc_interp_hann``, lowpass
  filter width 6, rolloff 0.99), which ``infer_v2.py`` runs from the
  prompt's 22 050 Hz to 16 kHz;
- ``kaldi_fbank``: Kaldi's log mel filterbank as
  ``torchaudio.compliance.kaldi.fbank`` computes it with its defaults
  (25 ms frames every 10 ms, snip edges, DC offset removed per frame,
  pre-emphasis 0.97, povey window, 512-point power spectrum, 80 triangles
  in Kaldi's mel space from 20 Hz to Nyquist, log floored at float32's
  epsilon, no dither);
- ``campplus_features``: that fbank of the wav, less its mean over time
  (CAM++'s input in ``infer_v2.py``);
- ``w2vbert_features``: transformers' ``SeamlessM4TFeatureExtractor``:
  the same filterbank of the wav scaled to 16-bit integers, each band
  normalised over time (mean, and variance with one degree of freedom,
  plus 1e-7), then pairs of frames stacked into 160-wide rows. An odd
  frame count drops its last frame (the extractor pads it and masks the
  stacked row out).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FRAME, HOP, NFFT = 400, 160, 512
EPS = 1.1920928955078125e-07


def resample(wav: torch.Tensor, orig: int, new: int,
             width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """wav (T,) float32 from ``orig`` Hz to ``new`` Hz:
    ceil(T·new/orig) samples."""
    if orig == new:
        return wav
    g = math.gcd(orig, new)
    o, n = orig // g, new // g
    base = min(o, n) * rolloff
    w = math.ceil(width * o / base)
    dev = wav.device
    idx = torch.arange(-w, w + o, dtype=torch.float64, device=dev)[None] / o
    t = (torch.arange(0, -n, -1, dtype=torch.float64, device=dev)[:, None]
         / n + idx) * base
    t = t.clamp(-width, width)
    window = torch.cos(t * math.pi / width / 2) ** 2
    t = t * math.pi
    kern = torch.where(t == 0, torch.ones_like(t), t.sin() / t)
    kern = (kern * window * (base / o)).float()[:, None]      # (n, 1, K)
    x = F.pad(wav.float()[None, None], (w, w + o))
    y = F.conv1d(x, kern, stride=o)[0].transpose(0, 1).reshape(-1)
    return y[: math.ceil(n * wav.shape[-1] / o)]


def kaldi_mel_banks(n_mels: int = 80, sample_rate: int = 16000,
                    low: float = 20.0, device=None) -> torch.Tensor:
    """Kaldi's triangular filters in its mel space, (n_mels, NFFT/2 + 1),
    the Nyquist column zero."""
    mel = lambda f: 1127.0 * math.log(1.0 + f / 700.0)
    lo, hi = mel(low), mel(sample_rate / 2.0)
    delta = (hi - lo) / (n_mels + 1)
    b = torch.arange(n_mels, dtype=torch.float64, device=device)[:, None]
    left, center, right = lo + b * delta, lo + (b + 1) * delta, \
        lo + (b + 2) * delta
    f = torch.arange(NFFT // 2, dtype=torch.float64, device=device) \
        * (sample_rate / NFFT)
    m = 1127.0 * torch.log(1.0 + f / 700.0)[None]
    up = (m - left) / (center - left)
    down = (right - m) / (right - center)
    banks = torch.clamp(torch.minimum(up, down), min=0.0)
    return F.pad(banks, (0, 1)).float()


def kaldi_fbank(wav: torch.Tensor, n_mels: int = 80,
                sample_rate: int = 16000) -> torch.Tensor:
    """wav (T,) float32 at 16 kHz → log mel filterbank (frames, n_mels)."""
    frames = wav.float().unfold(0, FRAME, HOP)
    frames = frames - frames.mean(dim=1, keepdim=True)
    prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    frames = frames - 0.97 * prev
    win = torch.hann_window(FRAME, periodic=False, dtype=torch.float32,
                            device=wav.device).pow(0.85)
    frames = F.pad(frames * win, (0, NFFT - FRAME))
    power = torch.fft.rfft(frames).abs().pow(2.0)
    banks = kaldi_mel_banks(n_mels, sample_rate, device=wav.device)
    return torch.clamp(power @ banks.T, min=EPS).log()


def campplus_features(wav16: torch.Tensor) -> torch.Tensor:
    """CAM++'s input: (frames, 80), the fbank less its mean over time."""
    feat = kaldi_fbank(wav16)
    return feat - feat.mean(dim=0, keepdim=True)


def w2vbert_features(wav16: torch.Tensor) -> torch.Tensor:
    """w2v-BERT 2.0's input: (frames // 2, 160)."""
    feat = kaldi_fbank(wav16 * 32768.0)
    mu = feat.mean(dim=0, keepdim=True)
    var = feat.var(dim=0, keepdim=True, unbiased=True)
    feat = (feat - mu) / torch.sqrt(var + 1e-7)
    n = feat.shape[0] - feat.shape[0] % 2
    return feat[:n].reshape(n // 2, 2 * feat.shape[1])
