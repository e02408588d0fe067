"""Configuration: the reference's ``config.yaml`` schema as typed dataclasses.

Field names and defaults equal the JAX package's ``GPTConfig``
(models/gpt.py), ``BigVGANConfig`` (models/bigvgan.py) and ``MelConfig`` /
``EngineConfig`` / ``load_config`` (utils/config.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Sequence

import yaml


@dataclass(frozen=True)
class GPTConfig:
    model_dim: int = 1024
    layers: int = 20
    heads: int = 16
    max_mel_tokens: int = 605
    max_text_tokens: int = 402
    number_text_tokens: int = 12000
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193
    start_text_token: int = 0
    stop_text_token: int = 1
    mel_length_compression: int = 1024
    condition_num_latent: int = 32
    cond_output_size: int = 512
    cond_linear_units: int = 2048
    cond_attention_heads: int = 8
    cond_num_blocks: int = 6
    activation: str = "gelu_pytorch_tanh"
    perceiver_mult: int = 2
    # "conformer_perceiver" (v1.5) | "perceiver" (v1.0 legacy encoder)
    condition_type: str = "conformer_perceiver"

    @property
    def max_mel_seq(self) -> int:   # mel stream positions (start/stop/cond slot)
        return self.max_mel_tokens + 2 + 1

    @property
    def max_text_seq(self) -> int:
        return self.max_text_tokens + 2

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.heads


@dataclass(frozen=True)
class BigVGANConfig:
    gpt_dim: int = 1024
    upsample_initial_channel: int = 1536
    upsample_rates: Sequence[int] = (4, 4, 4, 4, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (8, 8, 4, 4, 4, 4)
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3
    num_mels: int = 100
    speaker_embedding_dim: int = 512
    activation: str = "snakebeta"
    snake_logscale: bool = True
    cond_in_each_up_layer: bool = True
    use_pallas: bool = False

    @property
    def num_upsamples(self) -> int:
        return len(self.upsample_rates)

    @property
    def num_kernels(self) -> int:
        return len(self.resblock_kernel_sizes)

    def stage_channels(self, i: int) -> int:
        return self.upsample_initial_channel // (2 ** (i + 1))


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 100
    mel_fmin: float = 0.0


@dataclass(frozen=True)
class EngineConfig:
    mel: MelConfig = field(default_factory=MelConfig)
    gpt: GPTConfig = field(default_factory=GPTConfig)
    bigvgan: BigVGANConfig = field(default_factory=BigVGANConfig)
    version: float = 1.5
    bpe_model: str = "bpe.model"
    gpt_checkpoint: str = "gpt.pth"
    bigvgan_checkpoint: str = "bigvgan_generator.pth"
    dvae_checkpoint: str = "dvae.pth"


def load_config(path: str | Path) -> EngineConfig:
    """Read the reference's ``config.yaml`` into an ``EngineConfig``."""
    raw: Dict[str, Any] = yaml.safe_load(Path(path).read_text())
    ds = raw.get("dataset", {})
    mel_raw = ds.get("mel", {})
    mel = MelConfig(
        sample_rate=mel_raw.get("sample_rate", 24000),
        n_fft=mel_raw.get("n_fft", 1024),
        hop_length=mel_raw.get("hop_length", 256),
        win_length=mel_raw.get("win_length", 1024),
        n_mels=mel_raw.get("n_mels", 100),
        mel_fmin=mel_raw.get("mel_fmin", 0.0),
    )
    g = raw.get("gpt", {})
    cm = g.get("condition_module", {})
    gpt = GPTConfig(
        model_dim=g.get("model_dim", 1024),
        layers=g.get("layers", 20),
        heads=g.get("heads", 16),
        max_mel_tokens=g.get("max_mel_tokens", 605),
        max_text_tokens=g.get("max_text_tokens", 402),
        number_text_tokens=g.get("number_text_tokens", 12000),
        number_mel_codes=g.get("number_mel_codes", 8194),
        start_mel_token=g.get("start_mel_token", 8192),
        stop_mel_token=g.get("stop_mel_token", 8193),
        start_text_token=g.get("start_text_token", 0),
        stop_text_token=g.get("stop_text_token", 1),
        mel_length_compression=g.get("mel_length_compression", 1024),
        activation=g.get("activation_function", "gelu_pytorch_tanh"),
        cond_output_size=cm.get("output_size", 512),
        cond_linear_units=cm.get("linear_units", 2048),
        cond_attention_heads=cm.get("attention_heads", 8),
        cond_num_blocks=cm.get("num_blocks", 6),
        perceiver_mult=cm.get("perceiver_mult", 2),
        condition_type=g.get("condition_type", "conformer_perceiver"),
    )
    b = raw.get("bigvgan", {})
    bigvgan = BigVGANConfig(
        gpt_dim=b.get("gpt_dim", 1024),
        upsample_initial_channel=b.get("upsample_initial_channel", 1536),
        upsample_rates=tuple(b.get("upsample_rates", (4, 4, 4, 4, 2, 2))),
        upsample_kernel_sizes=tuple(b.get("upsample_kernel_sizes", (8, 8, 4, 4, 4, 4))),
        resblock_kernel_sizes=tuple(b.get("resblock_kernel_sizes", (3, 7, 11))),
        resblock_dilation_sizes=tuple(tuple(d) for d in
                                      b.get("resblock_dilation_sizes",
                                            ((1, 3, 5),) * 3)),
        num_mels=b.get("num_mels", 100),
        speaker_embedding_dim=b.get("speaker_embedding_dim", 512),
        activation=b.get("activation", "snakebeta"),
        snake_logscale=b.get("snake_logscale", True),
        cond_in_each_up_layer=b.get("cond_d_vector_in_each_upsampling_layer", True),
    )
    return EngineConfig(
        mel=mel, gpt=gpt, bigvgan=bigvgan,
        version=raw.get("version", 1.5),
        bpe_model=ds.get("bpe_model", "bpe.model"),
        gpt_checkpoint=raw.get("gpt_checkpoint", "gpt.pth"),
        bigvgan_checkpoint=raw.get("bigvgan_checkpoint", "bigvgan_generator.pth"),
        dvae_checkpoint=raw.get("dvae_checkpoint", "dvae.pth"),
    )
