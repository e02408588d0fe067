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
    # the generator's ends: tanh (else a clamp to [-1, 1]) and conv_post's
    # bias. Class attributes, not fields (the fields are the JAX package's);
    # ``MelVocoderConfig`` makes them fields
    use_tanh_at_final = True
    use_bias_at_final = True

    @property
    def num_upsamples(self) -> int:
        return len(self.upsample_rates)

    @property
    def num_kernels(self) -> int:
        return len(self.resblock_kernel_sizes)

    def stage_channels(self, i: int) -> int:
        return self.upsample_initial_channel // (2 ** (i + 1))

    @property
    def speaker_conditioned(self) -> bool:
        """A speaker embedding enters (``cond_layer``, ``conds``); 0 wide
        means none."""
        return self.speaker_embedding_dim > 0


@dataclass(frozen=True)
class MelVocoderConfig(BigVGANConfig):
    """BigVGAN-v2 as a mel vocoder (``bigvgan_v2_24khz_100band_256x``'s
    config.json): a 100-band log-mel in, ×256, no speaker input, a clamp
    to [-1, 1] in place of tanh and conv_post without a bias."""
    gpt_dim: int = 100
    upsample_rates: Sequence[int] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (8, 8, 4, 4, 4, 4)
    speaker_embedding_dim: int = 0
    cond_in_each_up_layer: bool = False
    use_tanh_at_final: bool = False
    use_bias_at_final: bool = False


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


@dataclass(frozen=True)
class DiTConfig:
    """F5-TTS's DiT backbone (``F5TTS_Base.yaml``'s ``arch``)."""
    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    text_dim: int = 512
    conv_layers: int = 4
    text_mask_padding: bool = False
    pe_attn_head: int = 1
    mel_dim: int = 100
    # characters of the checkpoint's vocab.txt; 0 is the filler after +1
    text_num_embeds: int = 2545
    conv_pos_kernel: int = 31
    conv_pos_groups: int = 16
    time_freq_dim: int = 256
    text_max_pos: int = 4096


@dataclass(frozen=True)
class F5Config:
    """F5-TTS Base with the BigVGAN-v2 24 kHz 100-band ×256 mel vocoder:
    the DiT, its sampler and the vocoder's generator."""
    dit: DiTConfig = field(default_factory=DiTConfig)
    vocoder: MelVocoderConfig = field(default_factory=MelVocoderConfig)
    mel: MelConfig = field(default_factory=MelConfig)
    nfe_step: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: float = -1.0
    target_rms: float = 0.1


@dataclass(frozen=True)
class W2VBertConfig:
    """w2v-BERT 2.0's speech encoder (``facebook/w2v-bert-2.0``'s
    config.json): a conformer of 24 layers of 1024 over stacked 80-band
    fbanks, relative-key attention clamped to 64 left and 8 right, a causal
    depthwise conv of 31. IndexTTS-2 reads hidden state ``out_layer``, the
    output of that many layers."""
    hidden: int = 1024
    layers: int = 24
    out_layer: int = 17
    heads: int = 16
    intermediate: int = 4096
    feature_dim: int = 160        # 80 fbank bands stacked by stride 2
    conv_kernel: int = 31
    left_max_position: int = 64
    right_max_position: int = 8
    eps: float = 1e-5


@dataclass(frozen=True)
class CodecConfig:
    """MaskGCT's semantic codec (IndexTTS-2 ``config.yaml``,
    ``semantic_codec``): a Vocos ConvNeXt encoder, then one factorized
    vector quantizer of ``codebook_size`` codes of ``codebook_dim``."""
    codebook_size: int = 8192
    hidden_size: int = 1024
    codebook_dim: int = 8
    vocos_dim: int = 384
    vocos_intermediate_dim: int = 2048
    vocos_num_layers: int = 12


@dataclass(frozen=True)
class CAMPPlusConfig:
    """3D-Speaker's CAM++ as IndexTTS-2 builds it
    (``CAMPPlus(feat_dim=80, embedding_size=192)``, the class defaults
    otherwise)."""
    feat_dim: int = 80
    embedding_size: int = 192
    growth_rate: int = 32
    bn_size: int = 4
    init_channels: int = 128
    m_channels: int = 32
    block_layers: Sequence[int] = (12, 24, 16)
    block_dilations: Sequence[int] = (1, 2, 2)
    kernel: int = 3


@dataclass(frozen=True)
class S2MConfig:
    """IndexTTS-2's semantic-to-mel stage (``config.yaml`` ``s2mel``): the
    GPT latent's ``gpt_layer`` (1280 → 256 → 128 → 1024), the
    interpolating length regulator (1024 → 512, four conv-GroupNorm-Mish
    blocks), and seed-vc's DiT (13 layers of 512, 8 heads, U-ViT skips, a
    long skip, an 8-layer WaveNet head of kernel 5) conditioned on time, the
    prompt mel and a 192-d style. ``intermediate`` is the SwiGLU width
    gpt-fast's ``ModelArgs`` derives (find_multiple(int(2·4·512/3), 256))."""
    in_channels: int = 80
    hidden_dim: int = 512
    num_heads: int = 8
    depth: int = 13
    intermediate: int = 1536
    style_dim: int = 192
    content_dim: int = 512
    regulator_in: int = 1024
    regulator_blocks: int = 4
    gpt_dim: int = 1280
    gpt_layer: Sequence[int] = (256, 128)
    wavenet_hidden: int = 512
    wavenet_layers: int = 8
    wavenet_kernel: int = 5
    time_freq_dim: int = 256
    norm_eps: float = 1e-5
    rope_base: float = 10000.0


@dataclass(frozen=True)
class IndexTTS2Config:
    """IndexTTS-2 (``IndexTeam/IndexTTS-2`` ``config.yaml``): the GPT over
    50 Hz semantic codes with its speaker and emotion conditioners and
    duration rows, the front end (w2v-BERT 2.0, the semantic codec,
    CAM++), the S2M flow-matching DiT and BigVGAN-v2 22 kHz 80-band ×256.
    ``cond_input`` is the width of the features both conditioners read;
    ``emo_*`` the emotion conditioner (a conformer, then a perceiver of
    ``emo_dim`` with one latent)."""
    gpt: GPTConfig = field(default_factory=lambda: GPTConfig(
        model_dim=1280, layers=24, heads=20, max_mel_tokens=1815,
        max_text_tokens=600))
    cond_input: int = 1024
    emo_output_size: int = 512
    emo_linear_units: int = 1024
    emo_attention_heads: int = 4
    emo_num_blocks: int = 4
    emo_perceiver_mult: int = 2
    emo_dim: int = 1024
    w2vbert: W2VBertConfig = field(default_factory=W2VBertConfig)
    codec: CodecConfig = field(default_factory=CodecConfig)
    campplus: CAMPPlusConfig = field(default_factory=CAMPPlusConfig)
    s2m: S2MConfig = field(default_factory=S2MConfig)
    vocoder: MelVocoderConfig = field(default_factory=lambda: MelVocoderConfig(
        gpt_dim=80, num_mels=80))
    mel: MelConfig = field(default_factory=lambda: MelConfig(
        sample_rate=22050, n_mels=80))
    semantic_rate: int = 16000
    code_rate: float = 50.0
    # mel frames per semantic code (infer_v2: ``code_lens * 1.72``)
    frames_per_code: float = 1.72
    diffusion_steps: int = 25
    cfg_rate: float = 0.7


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
