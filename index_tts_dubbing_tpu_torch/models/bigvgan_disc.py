"""BigVGAN's training-side discriminators and GAN losses.

Counterpart of the JAX package's ``models/bigvgan_disc.py`` (after
BigVGAN/models.py): the multi-period discriminator (periods 2, 3, 5, 7, 11;
2-D convs over the period-folded wav) and the multi-resolution STFT
discriminator (resolutions (1024, 120, 600), (2048, 240, 1200),
(512, 50, 240)), with the feature-matching and LSGAN losses. Inference
never runs them. Activations are channels-last (B, H, W, C) and the conv
kernels HWIO, so the JAX trees come across through ``weights
.from_jax_params`` unchanged.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch import nn
from index_tts_dubbing_tpu_torch.weights import Init

Params = Dict[str, Any]

LRELU_SLOPE = 0.1
MPD_PERIODS = (2, 3, 5, 7, 11)
MRD_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))
_P_CHANNELS = (32, 128, 512, 1024, 1024)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


# --- DiscriminatorP (period) ------------------------------------------------

def disc_p_forward(p: Params, wav: torch.Tensor, period: int
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """wav (B, T) → (score (B, N), feature maps). A length that the period
    does not divide is extended by its last samples reversed, as in JAX."""
    b, t = wav.shape
    if t % period:
        pad = period - t % period
        wav = torch.cat([wav, wav[:, t - pad:].flip(1)], dim=1)
        t += pad
    x = wav.reshape(b, t // period, period, 1)   # (B, H=time, W=period, 1)
    fmap = []
    for i, conv in enumerate(p["convs"]):
        x = _lrelu(nn.conv2d(conv, x, stride=(3, 1) if i < 4 else (1, 1),
                             padding=((2, 2), (0, 0))))
        fmap.append(x)
    x = nn.conv2d(p["post"], x, padding=((1, 1), (0, 0)))
    fmap.append(x)
    return x.reshape(b, -1), fmap


def init_disc_p(r: Init, kernel_size: int = 5, mult: int = 1) -> Params:
    chans = [1] + [int(c * mult) for c in _P_CHANNELS]
    return {"convs": [r.conv2d(chans[i], chans[i + 1], kernel_size, 1)
                      for i in range(5)],
            "post": r.conv2d(chans[-1], 1, 3, 1)}


# --- DiscriminatorR (resolution) --------------------------------------------

def stft_mag(wav: torch.Tensor, n_fft: int, hop: int, win: int
             ) -> torch.Tensor:
    """(B, T) → (B, n_fft // 2 + 1, frames): the magnitude STFT with no
    centring after a reflect pad of (n_fft − hop) / 2 on each side, under a
    rectangular window of ``win`` samples zero-padded to n_fft at the
    centre (the reference passes torch.stft no window)."""
    pad = (n_fft - hop) // 2
    wav = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    window = torch.zeros(n_fft, device=wav.device)
    lp = (n_fft - win) // 2
    window[lp:lp + win] = 1.0
    frames = wav.unfold(-1, n_fft, hop) * window
    return torch.fft.rfft(frames.float(), dim=-1).abs().transpose(1, 2)


def disc_r_forward(p: Params, wav: torch.Tensor, resolution: Sequence[int]
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    x = stft_mag(wav, *resolution)[..., None]       # (B, F, frames, 1)
    strides = [(1, 1), (1, 2), (1, 2), (1, 2), (1, 1)]
    pads = [((1, 1), (4, 4))] * 4 + [((1, 1), (1, 1))]
    fmap = []
    for conv, s, pad in zip(p["convs"], strides, pads):
        x = _lrelu(nn.conv2d(conv, x, stride=s, padding=pad))
        fmap.append(x)
    x = nn.conv2d(p["post"], x, padding=((1, 1), (1, 1)))
    fmap.append(x)
    return x.reshape(x.shape[0], -1), fmap


def init_disc_r(r: Init, mult: int = 1) -> Params:
    ch = int(32 * mult)
    kernels = [(3, 9)] * 4 + [(3, 3)]
    return {"convs": [r.conv2d(1 if i == 0 else ch, ch, kh, kw)
                      for i, (kh, kw) in enumerate(kernels)],
            "post": r.conv2d(ch, 1, 3, 3)}


# --- the two families and the losses ----------------------------------------

def init_mpd(generator: torch.Generator, device="cuda", mult: int = 1
             ) -> Params:
    """Random multi-period discriminator (the JAX init's shapes and
    torch-default conv bounds)."""
    r = Init(generator, device)
    return {"discs": [init_disc_p(r, mult=mult) for _ in MPD_PERIODS]}


def init_mrd(generator: torch.Generator, device="cuda", mult: int = 1
             ) -> Params:
    r = Init(generator, device)
    return {"discs": [init_disc_r(r, mult=mult) for _ in MRD_RESOLUTIONS]}


def _both(forward, discs, settings, y, y_hat):
    rs, gs, frs, fgs = [], [], [], []
    for d, s in zip(discs, settings):
        r, fr = forward(d, y, s)
        g, fg = forward(d, y_hat, s)
        rs.append(r)
        gs.append(g)
        frs.append(fr)
        fgs.append(fg)
    return rs, gs, frs, fgs


def mpd_forward(p: Params, y: torch.Tensor, y_hat: torch.Tensor):
    """(real scores, generated scores, real fmaps, generated fmaps)."""
    return _both(disc_p_forward, p["discs"], MPD_PERIODS, y, y_hat)


def mrd_forward(p: Params, y: torch.Tensor, y_hat: torch.Tensor):
    return _both(disc_r_forward, p["discs"], MRD_RESOLUTIONS, y, y_hat)


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """2 · Σ mean |real − generated| over every feature map."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + (rl - gl).abs().mean()
    return loss * 2.0


def discriminator_loss(real_outs, gen_outs):
    """LSGAN: (Σ mean (1 − real)² + mean generated², per-disc real losses,
    per-disc generated losses)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(real_outs, gen_outs):
        r = (1.0 - dr).square().mean()
        g = dg.square().mean()
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(gen_outs):
    """(Σ mean (1 − generated)², per-disc losses)."""
    loss = 0.0
    gen_losses = []
    for dg in gen_outs:
        l = (1.0 - dg).square().mean()
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses
