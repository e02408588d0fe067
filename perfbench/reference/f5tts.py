"""The plain reference of F5-TTS Base with BigVGAN-v2 ×256 that decides
``correct`` in an F5 cell.

Plain PyTorch, float32 unless told otherwise, TF32 off unless told
otherwise (``tf32_mode``): F5-TTS's DiT (``model/backbones/dit.py``,
``model/modules.py``) written for one row at a time, its guided Euler
sampler (``model/cfm.py``: the sway-sampled grid, the conditioned and the
unconditioned forward one after the other, not as one batch), BigVGAN's
log-mel (``get_mel_spectrogram``: reflect pad (n_fft - hop)/2, no centring,
slaney filterbank with slaney norm, log of clamp 1e-5) and the ×256 mel
vocoder over a whole line at once (no windows, no halos, no patches) on the
exact anti-aliased activations of ``perfbench/reference``. It imports
neither JAX nor anything of the program, and takes nothing the program
made: it reads the prompt from its file, maps the texts to ids itself,
works out each line's frames from the line's duration and draws each
line's noise from the line's seed (``F5Reference.noise``).

Rows are never padded here: each line runs at its own length, so the
program's masks and its per-row text encoding in a padded batch are what
the comparison checks.
"""
from __future__ import annotations

import math
import wave
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import nn
from perfbench.reference import to_i16, tf32_mode
from perfbench.reference.alias_free import anti_aliased_activation
from perfbench.reference.bigvgan import _amp_block

Params = Dict[str, Any]


# -- mel -----------------------------------------------------------------
def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f * 3.0 / 200.0
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (math.log(6.4)
                                                          / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0,
                    1000.0 * np.exp(math.log(6.4) / 27.0 * (m - 15.0)),
                    m * 200.0 / 3.0)


def slaney_mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                     fmax: Optional[float] = None) -> np.ndarray:
    """``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)``: slaney scale
    and norm, (n_mels, n_fft // 2 + 1)."""
    fmax = sr / 2.0 if fmax is None else fmax
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    weights = np.zeros((n_mels, 1 + n_fft // 2))
    for i in range(n_mels):
        lower = (fftfreqs - mel_f[i]) / (mel_f[i + 1] - mel_f[i])
        upper = (mel_f[i + 2] - fftfreqs) / (mel_f[i + 2] - mel_f[i + 1])
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
        weights[i] *= 2.0 / (mel_f[i + 2] - mel_f[i])
    return weights.astype(np.float32)


def bigvgan_mel(wav: torch.Tensor, m: Dict[str, Any]) -> torch.Tensor:
    """wav (T,) float32 → log-mel (frames, n_mels)."""
    n_fft, hop = m["n_fft"], m["hop_length"]
    basis = torch.as_tensor(slaney_mel_basis(
        m["sample_rate"], n_fft, m["n_mels"], m.get("mel_fmin", 0.0)),
        device=wav.device)
    pad = (n_fft - hop) // 2
    x = F.pad(wav[None, None], (pad, pad), mode="reflect")[0]
    spec = torch.stft(x, n_fft, hop_length=hop, win_length=m["win_length"],
                      window=torch.hann_window(m["win_length"],
                                               device=wav.device),
                      center=False, return_complex=True)
    mag = torch.sqrt(torch.view_as_real(spec).pow(2).sum(-1) + 1e-9)
    return torch.log(torch.clamp(basis @ mag[0], min=1e-5)).T


# -- the DiT, one row ------------------------------------------------------
def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def _mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _conv(p: Params, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Same-length conv1d over (1, N, C), odd kernel."""
    return nn.conv1d(p, x, padding=p["w"].shape[0] // 2, groups=groups)


def text_embed(p: Params, a: Dict[str, Any], ids: Sequence[int], n: int,
               dtype) -> torch.Tensor:
    """F5's ``TextEmbedding`` at one row's length ``n``: ids shifted by one,
    cut to n, filler 0 to n; embedding + cos | sin position; ConvNeXt-V2
    blocks. → (1, n, T)."""
    dev = p["emb"]["w"].device
    t = torch.zeros(n, dtype=torch.long, device=dev)
    row = torch.as_tensor(list(ids)[:n], dtype=torch.long, device=dev) + 1
    t[: row.numel()] = row
    x = p["emb"]["w"][t][None].to(dtype)
    dim = a["text_dim"]
    freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, device=dev)
                                [: dim // 2].float() / dim))
    ang = torch.outer(torch.arange(a["text_max_pos"], device=dev).float(),
                      freqs)
    table = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    x = x + table[torch.clamp(torch.arange(n, device=dev),
                              max=a["text_max_pos"] - 1)].to(dtype)
    for blk in p["blocks"]:
        y = _conv(blk["dw"], x, groups=dim)
        y = nn.layer_norm(blk["norm"], y, eps=1e-6)
        y = nn.gelu_exact(nn.linear(blk["pw1"], y))
        gx = torch.norm(y, p=2, dim=1, keepdim=True)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        y = blk["grn"]["gamma"].to(dtype) * (y * nx) \
            + blk["grn"]["beta"].to(dtype) + y
        x = x + nn.linear(blk["pw2"], y)
    return x


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x.unbind(-1)
    return torch.stack((-x2, x1), dim=-1).reshape(*x.shape[:-2], -1)


def dit_forward(p: Params, a: Dict[str, Any], x: torch.Tensor,
                cond: torch.Tensor, text: torch.Tensor, t: float, dtype
                ) -> torch.Tensor:
    """One row, no mask: x and cond (1, n, M), text (1, n, T), the time
    ``t`` → the velocity (1, n, M)."""
    dev = x.device
    n = x.shape[1]
    half = a["time_freq_dim"] // 2
    e = torch.exp(torch.arange(half, device=dev).float()
                  * -(math.log(10000) / (half - 1)))
    e = 1000.0 * torch.tensor([t], device=dev, dtype=torch.float32) * e
    tt = torch.cat([e.sin(), e.cos()])[None].to(dtype)
    tt = nn.linear(p["time"]["l2"], nn.silu(nn.linear(p["time"]["l1"], tt)))
    h = nn.linear(p["input"]["proj"], torch.cat([x, cond, text], dim=-1))
    g = a["conv_pos_groups"]
    c = _mish(_conv(p["input"]["conv1"], h, groups=g))
    h = _mish(_conv(p["input"]["conv2"], c, groups=g)) + h
    heads, dh, pn = a["heads"], a["dim_head"], a["pe_attn_head"]
    inv = 1.0 / (10000 ** (torch.arange(0, dh, 2, device=dev).float() / dh))
    f = torch.outer(torch.arange(n, device=dev).float(), inv)
    f = torch.stack((f, f), dim=-1).reshape(n, dh)
    cos, sin = f.cos().to(dtype), f.sin().to(dtype)
    st = nn.silu(tt)
    for blk in p["blocks"]:
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = nn.linear(blk["mod"], st).chunk(
            6, dim=-1)
        u = _ln(h) * (1 + sc_a) + sh_a
        q, k, v = (nn.linear(blk[w], u).view(1, n, heads, dh).transpose(1, 2)
                   for w in ("q", "k", "v"))
        q = torch.cat([q[:, :pn] * cos + _rotate_half(q[:, :pn]) * sin,
                       q[:, pn:]], dim=1)
        k = torch.cat([k[:, :pn] * cos + _rotate_half(k[:, :pn]) * sin,
                       k[:, pn:]], dim=1)
        w = torch.softmax((q @ k.transpose(-1, -2)).float()
                          / math.sqrt(dh), dim=-1).to(dtype)
        o = (w @ v).transpose(1, 2).reshape(1, n, heads * dh)
        h = h + g_a * nn.linear(blk["o"], o)
        u = _ln(h) * (1 + sc_f) + sh_f
        h = h + g_f * nn.linear(blk["ff2"],
                                nn.gelu_tanh(nn.linear(blk["ff1"], u)))
    scale, shift = nn.linear(p["final"]["mod"], st).chunk(2, dim=-1)
    return nn.linear(p["final"]["proj"], _ln(h) * (1 + scale) + shift)


def time_grid(nfe: int, sway: float) -> List[float]:
    """F5's sway-sampled grid, worked in float32."""
    t = torch.linspace(0.0, 1.0, nfe + 1)
    return (t + sway * (torch.cos(torch.pi / 2 * t) - 1 + t)).tolist()


# -- the mel vocoder -------------------------------------------------------
def vocode(p: Params, b: Any, mel: torch.Tensor) -> torch.Tensor:
    """BigVGAN-v2 as a mel vocoder over a whole line: mel (1, T, M) → wav
    (1, T·256): conv_pre, the stages with no speaker input, snakebeta,
    conv_post without a bias, a clamp to [-1, 1]."""
    x = nn.conv1d(p["conv_pre"], mel, padding=3)
    for i, (u, k) in enumerate(zip(b.upsample_rates,
                                   b.upsample_kernel_sizes)):
        x = nn.conv_transpose1d(p["ups"][i], x, stride=u,
                                padding=(k - u) // 2)
        xs = None
        for j, kk in enumerate(b.resblock_kernel_sizes):
            y = _amp_block(b, p["resblocks"][i * b.num_kernels + j], x, kk,
                           b.resblock_dilation_sizes[j])
            xs = y if xs is None else xs + y
        x = xs / b.num_kernels
    act = p["act_post"]
    x = anti_aliased_activation(x, act["alpha"], act.get("beta"),
                                b.snake_logscale)
    x = nn.conv1d(p["conv_post"], x, padding=3)
    return x.clamp(-1.0, 1.0)[..., 0]


class F5Reference:
    """F5-TTS on one prompt: each line's mel from a given noise, and the
    int16 waveform of a mel."""

    def __init__(self, params: Dict[str, Any], cfg: Dict[str, Any],
                 dtype: torch.dtype = torch.float32, tf32: bool = False):
        from perfbench.reference import _bigvgan_cfg
        self.p, self.cfg, self.dtype, self.tf32 = params, cfg, dtype, tf32
        self.arch = dict(cfg["arch"], **cfg["defaults"],
                         **{k: v["value"] for k, v in cfg["assumed"].items()})
        self.bcfg = _bigvgan_cfg(cfg["vocoder"]["bigvgan"])
        self.device = params["dit"]["final"]["proj"]["w"].device

    def set_prompt(self, wav_path) -> None:
        """The prompt's mel at F5's loudness, and its own RMS."""
        with wave.open(str(wav_path), "rb") as w:
            sr = w.getframerate()
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        m = self.cfg["mel"]
        if sr != m["sample_rate"]:
            raise ValueError(f"prompt at {sr} Hz, the model takes "
                             f"{m['sample_rate']}")
        wav = torch.as_tensor(pcm.astype(np.float32) / 32768.0,
                              device=self.device)
        self.rms = float(torch.sqrt(torch.mean(wav.double() ** 2)))
        target = self.cfg["sampler"]["target_rms"]
        if self.rms < target:
            wav = wav * (target / self.rms)
        with tf32_mode(self.tf32):
            self.cond = bigvgan_mel(wav, m)                   # (Tp, M)

    def text_ids(self, ref_text: str, text: str) -> List[int]:
        """F5's joined text as ids: the transcript ends in ". " (a final
        '.' gains a space), then the line; a character's id is its code
        point modulo the vocabulary (no vocab.txt here)."""
        if not ref_text.endswith(". "):
            ref_text += " " if ref_text.endswith(".") else ". "
        return [ord(c) % self.arch["text_num_embeds"]
                for c in ref_text + text]

    def frames(self, seconds: float) -> int:
        m = self.cfg["mel"]
        return int(seconds * m["sample_rate"] / m["hop_length"])

    def noise(self, seed: int, n: int) -> torch.Tensor:
        """A line's start: (n, M) float32 N(0, 1) from a generator on the
        reference's device seeded with ``seed`` (the engine's rule: row i
        of a call with seed s draws from s + i)."""
        g = torch.Generator(self.device).manual_seed(int(seed))
        return torch.randn((n, self.arch["mel_dim"]), generator=g,
                           device=self.device)

    def sample(self, ids: Sequence[int], n: int, noise: torch.Tensor,
               s: Dict[str, Any]) -> torch.Tensor:
        """One line of ``n`` frames from ``noise`` (n, M) with the sampler's
        settings ``s`` (``nfe_step``, ``cfg_strength``,
        ``sway_sampling_coef``): the guided Euler ODE, the prompt restored
        → (n, M) float32."""
        a = self.arch
        p, dt = self.p["dit"], self.dtype
        tp = self.cond.shape[0]
        with tf32_mode(self.tf32):
            cond = torch.zeros((1, n, a["mel_dim"]), device=self.device,
                               dtype=dt)
            cond[0, :tp] = self.cond.to(dt)
            text_c = text_embed(p["text"], a, ids, n, dt)
            text_u = text_embed(p["text"], a, [-1] * n, n, dt)
            x = noise[None].to(dt)
            grid = time_grid(s["nfe_step"], s["sway_sampling_coef"])
            for t0, t1 in zip(grid[:-1], grid[1:]):
                v_c = dit_forward(p, a, x, cond, text_c, t0, dt)
                v_u = dit_forward(p, a, x, torch.zeros_like(cond), text_u,
                                  t0, dt)
                x = x + (t1 - t0) * (v_c + (v_c - v_u) * s["cfg_strength"])
            x[0, :tp] = cond[0, :tp]
        return x[0].float()

    def vocode_i16(self, mel: torch.Tensor, tf32: Optional[bool] = None
                   ) -> np.ndarray:
        """A line's generated mel (T, M) → its int16 wav, scaled back by
        the prompt's loudness as F5 does; TF32 as the reference was built
        unless ``tf32`` says otherwise."""
        if mel.shape[0] == 0:
            return np.zeros(0, np.int16)
        target = self.cfg["sampler"]["target_rms"]
        scale = self.rms / target if self.rms < target else 1.0
        with tf32_mode(self.tf32 if tf32 is None else tf32):
            wav = vocode(self.p["vocoder"], self.bcfg,
                         mel[None].to(self.dtype))[0]
        return to_i16(wav.float().cpu().numpy() * scale)
