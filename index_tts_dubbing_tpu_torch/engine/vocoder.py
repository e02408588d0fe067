"""Windowed streaming vocoder in the C-major layout, on the two kernels.

Counterpart of the JAX package's ``engine/vocoder.py`` (its cmajor route as
the engine runs it on its chip, ``vocoder.py:376-400``): the latent stream
is cut into windows of 112 frames with 16-frame halos, each window batch
runs BigVGAN as (B, C, T) with kernel K1 (ops/snake_cmajor.py) for every
anti-aliased activation of the C > 128 stages and ``act_post``, and kernel
K2 (ops/resblock_cmajor.py) for every whole resblock of the C ≤ 128 stages;
the halo-cropped outputs are stitched.

The kernels replicate-pad where the reference zero-pads each conv, which is
exact wherever a true stream boundary is ≥ halo away. So the first and last
``halo`` frames of the stream are re-vocoded by the exact route (plain
torch, zero-pad convs, ``use_kernels=False``) on two patches of 2·halo
frames and written over the fast output (``_apply_edge_patches``).

The vocoder's dtype: windows enter in the parameters' dtype; adding the
float32 speaker conditioning promotes the rest to float32, exactly as the
JAX package's type promotion does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch.config import BigVGANConfig
from index_tts_dubbing_tpu_torch.models import ecapa
from index_tts_dubbing_tpu_torch.ops.alias_free import (
    anti_aliased_activation_cmajor)
from index_tts_dubbing_tpu_torch.ops.resblock_cmajor import (pack_resblock,
                                                             resblock_cmajor)

# halo: BigVGAN's receptive field in latent frames, ±12; 16 keeps window
# seams exact
DEFAULT_HALO = 16


def _conv1d_cm(p: Dict[str, Any], x: torch.Tensor, *, dilation: int = 1,
               padding: int = 0) -> torch.Tensor:
    """1-D conv over (B, C, T); weights in the shared (K, Cin, Cout) layout,
    zero padding."""
    y = F.conv1d(x, p["w"].to(x.dtype).permute(2, 1, 0), padding=padding,
                 dilation=dilation)
    return y + p["b"].to(x.dtype)[:, None]


def _conv_transpose1d_cm(p: Dict[str, Any], x: torch.Tensor, *, stride: int,
                         padding: int = 0) -> torch.Tensor:
    y = F.conv_transpose1d(x, p["w"].to(x.dtype).permute(2, 1, 0),
                           stride=stride, padding=padding)
    return y + p["b"].to(x.dtype)[:, None]


def _act_cm(cfg: BigVGANConfig, p: Dict[str, Any], x: torch.Tensor,
            use_kernel: bool) -> torch.Tensor:
    beta = p.get("beta") if cfg.activation == "snakebeta" else None
    return anti_aliased_activation_cmajor(x, p["alpha"], beta,
                                          cfg.snake_logscale, use_kernel)


def pack_fused_resblocks(params: Dict[str, Any], cfg: BigVGANConfig,
                         dtype) -> Dict[int, Tuple[torch.Tensor, ...]]:
    """K2's packed weights for every resblock of the C ≤ 128 stages, keyed by
    flat resblock index."""
    packed = {}
    for i in range(cfg.num_upsamples):
        if cfg.stage_channels(i) > 128:
            continue
        for j in range(cfg.num_kernels):
            k = i * cfg.num_kernels + j
            packed[k] = pack_resblock(params["resblocks"][k], cfg, dtype)
    return packed


def _vocode_window_cmajor(params: Dict[str, Any], cfg: BigVGANConfig,
                         latent: torch.Tensor, spk: torch.Tensor,
                         use_kernels: bool = True,
                         packed: Optional[Dict[int, Tuple]] = None
                         ) -> torch.Tensor:
    """Windows (B, W, gpt_dim) + speaker embedding ((1|B), 1, spk_dim) →
    wav (B, W·1024), entirely in the (B, C, T) layout. ``use_kernels``: K1
    for the C > 128 stages' activations and act_post, K2 for the C ≤ 128
    stages' resblocks; False is the exact route. ``packed``: K2's weights
    from ``pack_fused_resblocks`` for the compute dtype (None packs
    inline)."""
    if spk.shape[0] == 1 and latent.shape[0] > 1:
        spk = spk.expand((latent.shape[0],) + spk.shape[1:])
    spk_cm = spk.transpose(1, 2)
    x = _conv1d_cm(params["conv_pre"], latent.transpose(1, 2), padding=3)
    x = x + _conv1d_cm(params["cond_layer"], spk_cm)
    for i in range(cfg.num_upsamples):
        u = cfg.upsample_rates[i]
        k = cfg.upsample_kernel_sizes[i]
        x = _conv_transpose1d_cm(params["ups"][i], x, stride=u,
                                 padding=(k - u) // 2)
        if cfg.cond_in_each_up_layer:
            x = x + _conv1d_cm(params["conds"][i], spk_cm)
        xs = None
        for j in range(cfg.num_kernels):
            idx = i * cfg.num_kernels + j
            rb = params["resblocks"][idx]
            kk = cfg.resblock_kernel_sizes[j]
            dils = tuple(cfg.resblock_dilation_sizes[j])
            if use_kernels and x.shape[1] <= 128:
                w = (packed[idx] if packed is not None
                     else pack_resblock(rb, cfg, x.dtype))
                y = resblock_cmajor(x, *w, kk, dils)
            else:
                y = x
                for c1, c2, a1, a2, d in zip(rb["convs1"], rb["convs2"],
                                             rb["acts"][::2], rb["acts"][1::2],
                                             dils):
                    yt = _act_cm(cfg, a1, y, use_kernels)
                    yt = _conv1d_cm(c1, yt, dilation=d, padding=(kk * d - d) // 2)
                    yt = _act_cm(cfg, a2, yt, use_kernels)
                    yt = _conv1d_cm(c2, yt, padding=(kk - 1) // 2)
                    y = yt + y
            xs = y if xs is None else xs + y
        x = xs / cfg.num_kernels
    x = _act_cm(cfg, params["act_post"], x, use_kernels)
    x = _conv1d_cm(params["conv_post"], x, padding=3)
    return torch.tanh(x)[:, 0, :]


def speaker_embedding(params: Dict[str, Any], mel_ref: torch.Tensor) -> torch.Tensor:
    """mel_ref (B, T, n_mels) → (B, 1, spk_dim)."""
    return ecapa.forward(params["speaker_encoder"], mel_ref)


class WindowedVocoder:
    """Vocode latent streams of any length through fixed-size windows in
    batches of power-of-two sizes (largest ≤ ``max_batch`` first)."""

    def __init__(self, params: Dict[str, Any], cfg: BigVGANConfig,
                 window: int = 112, halo: int = DEFAULT_HALO,
                 max_batch: int = 32, compute_dtype=torch.float32):
        self.params = params
        self.cfg = cfg
        self.window = window
        self.halo = halo
        self.max_batch = max_batch
        self.compute_dtype = compute_dtype
        self.upsample = int(np.prod(cfg.upsample_rates))
        self._packed: Dict[torch.dtype, Dict[int, Tuple]] = {}

    def speaker_embedding(self, mel_ref: torch.Tensor) -> torch.Tensor:
        return speaker_embedding(self.params, mel_ref)

    def _vocode(self, windows: torch.Tensor, spk: torch.Tensor,
                exact: bool) -> torch.Tensor:
        if exact:
            return _vocode_window_cmajor(self.params, self.cfg, windows, spk,
                                        use_kernels=False)
        dt = torch.promote_types(windows.dtype, spk.dtype)
        if dt not in self._packed:
            self._packed[dt] = pack_fused_resblocks(self.params, self.cfg, dt)
        return _vocode_window_cmajor(self.params, self.cfg, windows, spk,
                                    use_kernels=True, packed=self._packed[dt])

    # -- window plan ---------------------------------------------------
    def _window_list(self, t: int) -> List[Tuple[int, int, int]]:
        """(start, end, window_lo) per window; windows are clamped inside
        [0, t] so a window edge is either the true boundary or ≥ halo away
        from every kept output frame."""
        w, h = self.window, self.halo
        full = w + 2 * h
        wins = []
        start = 0
        while start < t:
            end = min(start + w, t)
            wins.append((start, end, min(max(0, start - h), t - full)))
            start = end
        return wins

    def _plan_batches(self, wins):
        """Power-of-two batches (largest ≤ max_batch first), so no padded
        window is ever computed."""
        c0 = 0
        while c0 < len(wins):
            rem = len(wins) - c0
            n = min(self.max_batch, 1 << (rem.bit_length() - 1))
            yield wins[c0: c0 + n]
            c0 += n

    def _collect(self, out: torch.Tensor, chunk, wavs: torch.Tensor) -> None:
        up = self.upsample
        for i, (s, e, lo) in enumerate(chunk):
            off = s - lo
            out[s * up: e * up] = wavs[i, off * up: (off + e - s) * up]

    def _apply_edge_patches(self, out: torch.Tensor, t: int, fetch,
                            spk: torch.Tensor) -> None:
        """Overwrite out[: halo·up] and out[(t-halo)·up :] with the exact
        route's outputs over 2·halo-frame patches at the two stream ends;
        each patch keeps its boundary half, whose other edge is ≥ halo from
        every kept sample. ``fetch(lo, pw)`` returns latent frames
        [lo, lo+pw) as (pw, C)."""
        pw = 2 * self.halo
        up = self.upsample
        patches = torch.stack([fetch(0, pw), fetch(t - pw, pw)])
        ewav = self._vocode(patches, spk[:1], exact=True).float()
        out[: self.halo * up] = ewav[0, : self.halo * up]
        out[(t - self.halo) * up: t * up] = ewav[1, self.halo * up:]

    def stream_device(self, lat: torch.Tensor, lens, order=None,
                      spk: Optional[torch.Tensor] = None,
                      mel_ref: Optional[torch.Tensor] = None) -> np.ndarray:
        """Vocode the stream concat(lat[order[s], :lens[order[s]]]) that lives
        on the device: lat (rows, MB, C), lens (rows,) host ints. Windows are
        gathered on the device; the stitched float32 wav comes back to the
        host once. A stream no longer than one window runs the exact route
        at its own length."""
        lens = np.asarray(lens, np.int64)
        order = (np.arange(lens.size) if order is None
                 else np.asarray(order, np.int64))
        slens = lens[order]
        bounds = np.concatenate([[0], np.cumsum(slens)])
        t = int(bounds[-1])
        if t == 0:
            return np.zeros(0, np.float32)
        if spk is None:
            spk = self.speaker_embedding(mel_ref)
        dev = lat.device
        lat = lat.to(self.compute_dtype)
        flat = lat.reshape(-1, lat.shape[-1])
        mb = lat.shape[1]
        rows = np.repeat(order, slens)
        cols = np.arange(t) - np.repeat(bounds[:-1], slens)
        flatmap = torch.as_tensor(rows * mb + cols, device=dev)
        full = self.window + 2 * self.halo
        if t <= full:
            stream = flat[flatmap][None]
            wav = self._vocode(stream, spk[:1], exact=True)[0]
            return wav.float().cpu().numpy()
        out = torch.empty(t * self.upsample, dtype=torch.float32, device=dev)
        for chunk in self._plan_batches(self._window_list(t)):
            idx = torch.stack([flatmap[lo: lo + full] for (_, _, lo) in chunk])
            wavs = self._vocode(flat[idx], spk, exact=False).float()
            self._collect(out, chunk, wavs)
        self._apply_edge_patches(out, t,
                                 lambda lo, pw: flat[flatmap[lo: lo + pw]], spk)
        return out.cpu().numpy()
