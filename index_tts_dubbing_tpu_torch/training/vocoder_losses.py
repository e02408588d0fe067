"""BigVGAN training losses: multi-scale mel L1 and the GAN terms.

Counterpart of the JAX package's ``training/vocoder_losses.py`` (the
reference's ``use_multiscale_melloss: true, lambda_melloss: 15`` with the
discriminators of models/bigvgan_disc.py). The three mel scales run through
the port's ``ops/mel.py``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from index_tts_dubbing_tpu_torch.models import bigvgan_disc as disc
from index_tts_dubbing_tpu_torch.ops.mel import MelSpectrogram

MULTISCALE_MELS = (
    dict(n_fft=1024, hop_length=256, win_length=1024, n_mels=100),
    dict(n_fft=2048, hop_length=512, win_length=2048, n_mels=100),
    dict(n_fft=512, hop_length=128, win_length=512, n_mels=80),
)


def make_mel_banks(sample_rate: int = 24000, device="cuda"):
    return [MelSpectrogram(sample_rate=sample_rate, device=device, **cfg)
            for cfg in MULTISCALE_MELS]


def multiscale_mel_loss(banks, wav_real: torch.Tensor, wav_gen: torch.Tensor
                        ) -> torch.Tensor:
    """The mean over scales of L1(logmel(y), logmel(ŷ))."""
    loss = 0.0
    for mel in banks:
        loss = loss + (mel(wav_real) - mel(wav_gen)).abs().mean()
    return loss / len(banks)


def generator_total_loss(mpd_params, mrd_params, banks, wav_real, wav_gen,
                         lambda_mel: float = 15.0
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """LSGAN adversarial + feature matching (both families) + λ·mel."""
    _, gs_p, frs_p, fgs_p = disc.mpd_forward(mpd_params, wav_real, wav_gen)
    _, gs_r, frs_r, fgs_r = disc.mrd_forward(mrd_params, wav_real, wav_gen)
    adv_p, _ = disc.generator_loss(gs_p)
    adv_r, _ = disc.generator_loss(gs_r)
    fm = disc.feature_loss(frs_p, fgs_p) + disc.feature_loss(frs_r, fgs_r)
    mel = multiscale_mel_loss(banks, wav_real, wav_gen)
    total = adv_p + adv_r + fm + lambda_mel * mel
    return total, {"adv_mpd": adv_p, "adv_mrd": adv_r, "feature": fm,
                   "mel": mel}


def discriminator_total_loss(mpd_params, mrd_params, wav_real, wav_gen
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The discriminators' LSGAN loss; no gradient reaches ``wav_gen``."""
    wav_gen = wav_gen.detach()
    rs_p, gs_p, _, _ = disc.mpd_forward(mpd_params, wav_real, wav_gen)
    rs_r, gs_r, _, _ = disc.mrd_forward(mrd_params, wav_real, wav_gen)
    lp, _, _ = disc.discriminator_loss(rs_p, gs_p)
    lr, _, _ = disc.discriminator_loss(rs_r, gs_r)
    return lp + lr, {"mpd": lp, "mrd": lr}
