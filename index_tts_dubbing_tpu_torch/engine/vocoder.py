"""Windowed streaming vocoder: the C-major layout on kernels K1 and K2, or
the reference-structured channels-last layout.

Counterpart of the JAX package's ``engine/vocoder.py``. The latent stream
is cut into windows of 112 frames with 16-frame halos, each window batch
runs BigVGAN, and the halo-cropped outputs are stitched. Two layouts:

- ``"cmajor"`` (the default, and the engine's vocoder, as the JAX package's
  on its own accelerator, ``vocoder.py:376-400``): each window batch runs
  as (B, C, T). Two switches, JAX's, pick the kernels: ``fuse_resblocks``
  runs every whole resblock of the C ≤ 128 stages as kernel K2
  (ops/resblock_cmajor.py), and ``use_pallas`` runs every other
  anti-aliased activation (all of them without ``fuse_resblocks``, else
  those of the C > 128 stages and ``act_post``) as kernel K1
  (ops/snake_cmajor.py). With both off the window is the exact route
  (plain torch, zero-pad convs). The kernels replicate-pad where the
  reference zero-pads each conv, which is exact wherever a true stream
  boundary is ≥ halo away. So with ``edge_exact`` (the default whenever a
  kernel runs) the first and last ``halo`` frames of the stream are
  re-vocoded by the exact route on two patches of 2·halo frames and
  written over the fast output (``_apply_edge_patches``), and a stream of
  at most one window vocodes by the exact route; without it the ends keep
  the kernels' edge semantics. With a kernel switch on, that exact work
  runs on the same kernels in their exact-edge mode, which pads every op
  at the window's own two ends as the exact route does (the convs
  zero-pad, the activations replicate-pad); the plain route (both
  switches off, and every kernel's plain version on the CPU) runs the
  exact route's own ops, as the reference does.
- ``"ref"``: each window batch runs the reference-structured channels-last
  BigVGAN (models/bigvgan.py, ``_vocode_window``), whose activations take
  kernel B3 (ops/snake_clast.py) when ``cfg.use_pallas`` is set. The three
  switches change nothing here and, as in the JAX package, no edge patches
  are applied, so with B3 the outputs within its edge span of the true
  stream ends are B3's.

The vocoder's dtype: windows enter in the parameters' dtype; adding the
float32 speaker conditioning promotes the rest to float32, exactly as the
JAX package's type promotion does.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch.config import BigVGANConfig
from index_tts_dubbing_tpu_torch.models import bigvgan, ecapa
from index_tts_dubbing_tpu_torch.ops.alias_free import (
    anti_aliased_activation_cmajor)
from index_tts_dubbing_tpu_torch.ops import snake_cmajor as _k1
from index_tts_dubbing_tpu_torch.ops.resblock_cmajor import (pack_resblock,
                                                             resblock_cmajor)
from index_tts_dubbing_tpu_torch.utils import profiling

# halo: 16 latent frames against the ×1024 generator's receptive field of
# ±34 (``receptive_frames``): its outer frames weigh little, and a window
# seam differs from the exact route by about a quarter of an int16 step
# (7.7e-6 on a small seeded generator)
DEFAULT_HALO = 16
# input samples an anti-aliased activation reads on each side of its output
# (ops/alias_free.py: the ×2 up-phases read x[t-3 .. t+3], the 12-tap
# decimation up-samples 2t-5 .. 2t+6)
ACT_RADIUS = 5


def receptive_frames(cfg: BigVGANConfig) -> Tuple[int, int]:
    """The input frames one output frame of the generator reads, (before,
    after), worked backwards layer by layer from the output frame's
    samples: conv_post and act_post, then each stage's widest resblock
    (the three branches run side by side; each pair is act → dilated conv →
    act → conv) and its transposed conv (output n reads the inputs j with
    0 ≤ n + pad - j·u < k), then conv_pre. A window plan whose halo is at
    least the larger of the two gives the exact route's output in every
    kept frame."""
    up = int(np.prod(cfg.upsample_rates))
    lo, hi = 0, up - 1                    # output frame 0's samples
    lo, hi = lo - 3 - ACT_RADIUS, hi + 3 + ACT_RADIUS
    for i in reversed(range(cfg.num_upsamples)):
        r = max(sum(2 * ACT_RADIUS + (d + 1) * (k - 1) // 2 for d in dils)
                for k, dils in zip(cfg.resblock_kernel_sizes,
                                   cfg.resblock_dilation_sizes))
        lo, hi = lo - r, hi + r
        u, k = cfg.upsample_rates[i], cfg.upsample_kernel_sizes[i]
        pad = (k - u) // 2
        lo, hi = -((-(lo + pad - k + 1)) // u), (hi + pad) // u
    return 3 - lo, hi + 3


def _conv1d_cm(p: Dict[str, Any], x: torch.Tensor, *, dilation: int = 1,
               padding: int = 0) -> torch.Tensor:
    """1-D conv over (B, C, T); weights in the shared (K, Cin, Cout) layout,
    zero padding; the bias where ``p`` has one."""
    y = F.conv1d(x, p["w"].to(x.dtype).permute(2, 1, 0), padding=padding,
                 dilation=dilation)
    return y + p["b"].to(x.dtype)[:, None] if "b" in p else y


def _conv_transpose1d_cm(p: Dict[str, Any], x: torch.Tensor, *, stride: int,
                         padding: int = 0) -> torch.Tensor:
    y = F.conv_transpose1d(x, p["w"].to(x.dtype).permute(2, 1, 0),
                           stride=stride, padding=padding)
    return y + p["b"].to(x.dtype)[:, None]


def _act_cm(cfg: BigVGANConfig, p: Dict[str, Any], x: torch.Tensor,
            use_kernel: bool, exact_edge: bool = False) -> torch.Tensor:
    beta = p.get("beta") if cfg.activation == "snakebeta" else None
    return anti_aliased_activation_cmajor(x, p["alpha"], beta,
                                          cfg.snake_logscale, use_kernel,
                                          exact_edge)


def _resblock_cm(cfg: BigVGANConfig, rb: Dict[str, Any], x: torch.Tensor,
                 k: int, dils: Sequence[int], use_kernel: bool,
                 exact_edge: bool = False) -> torch.Tensor:
    """One resblock op by op: per pair act → conv (dilation d, zero pad) →
    act → conv → residual, the activations on K1 with ``use_kernel``."""
    y = x
    for c1, c2, a1, a2, d in zip(rb["convs1"], rb["convs2"], rb["acts"][::2],
                                 rb["acts"][1::2], dils):
        yt = _act_cm(cfg, a1, y, use_kernel, exact_edge)
        yt = _conv1d_cm(c1, yt, dilation=d, padding=(k * d - d) // 2)
        yt = _act_cm(cfg, a2, yt, use_kernel, exact_edge)
        yt = _conv1d_cm(c2, yt, padding=(k - 1) // 2)
        y = yt + y
    return y


def pack_fused_resblocks(params: Dict[str, Any], cfg: BigVGANConfig,
                         dtype, exact_edge: bool = False
                         ) -> Dict[int, Tuple[torch.Tensor, ...]]:
    """K2's packed weights for every resblock of the C ≤ 128 stages, keyed by
    flat resblock index; ``exact_edge``: for K2's exact-edge mode."""
    packed = {}
    for i in range(cfg.num_upsamples):
        if cfg.stage_channels(i) > 128:
            continue
        for j in range(cfg.num_kernels):
            k = i * cfg.num_kernels + j
            packed[k] = pack_resblock(params["resblocks"][k], cfg, dtype,
                                      exact_edge)
    return packed


# the K1 and K2 wrappers whose launch counters ``exact_span`` reads (held
# here, since callers may wrap the names the vocoder calls)
_COUNTED = (_k1.snake_cmajor, resblock_cmajor)


@contextlib.contextmanager
def exact_span(dev):
    """The span ``vocoder.exact`` (the boundary work: edge patches, a short
    stream vocoded whole) with its attribute ``kernel_launches``: the K1
    and K2 launches inside it, all in exact-edge mode; 0 when the plain
    route ran."""
    with profiling.span("vocoder.exact", device=dev) as sp:
        if not sp:
            yield sp
            return
        n0 = sum(f.launches for f in _COUNTED)
        yield sp
        sp.set(kernel_launches=sum(f.launches for f in _COUNTED) - n0)


def _vocode_window_cmajor(params: Dict[str, Any], cfg: BigVGANConfig,
                         latent: torch.Tensor, spk: Optional[torch.Tensor],
                         use_pallas: bool = True,
                         fuse_resblocks: bool = True,
                         packed: Optional[Dict[int, Tuple]] = None,
                         exact_edge: bool = False) -> torch.Tensor:
    """Windows (B, W, gpt_dim) + speaker embedding ((1|B), 1, spk_dim), or
    None for the mel vocoder → wav (B, W·upsample), entirely in the (B, C,
    T) layout. ``fuse_resblocks``:
    K2 for each resblock of the C ≤ 128 stages; ``use_pallas``: K1 for
    every activation outside those (JAX ``vocoder.py:285-304``); both off
    is the exact route. ``exact_edge``: the kernels in their exact-edge
    mode, so the whole is the exact route's semantics on the kernels.
    ``packed``: K2's weights from ``pack_fused_resblocks`` for the compute
    dtype and the mode (None packs inline)."""
    x = _conv1d_cm(params["conv_pre"], latent.transpose(1, 2), padding=3)
    if spk is not None:
        if spk.shape[0] == 1 and latent.shape[0] > 1:
            spk = spk.expand((latent.shape[0],) + spk.shape[1:])
        spk_cm = spk.transpose(1, 2)
        x = x + _conv1d_cm(params["cond_layer"], spk_cm)
    for i in range(cfg.num_upsamples):
        u = cfg.upsample_rates[i]
        k = cfg.upsample_kernel_sizes[i]
        x = _conv_transpose1d_cm(params["ups"][i], x, stride=u,
                                 padding=(k - u) // 2)
        if cfg.cond_in_each_up_layer and spk is not None:
            x = x + _conv1d_cm(params["conds"][i], spk_cm)
        xs = None
        for j in range(cfg.num_kernels):
            idx = i * cfg.num_kernels + j
            rb = params["resblocks"][idx]
            kk = cfg.resblock_kernel_sizes[j]
            dils = tuple(cfg.resblock_dilation_sizes[j])
            if fuse_resblocks and x.shape[1] <= 128:
                w = (packed[idx] if packed is not None
                     else pack_resblock(rb, cfg, x.dtype, exact_edge))
                y = resblock_cmajor(x, *w, kk, dils, exact_edge=exact_edge)
            else:
                y = _resblock_cm(cfg, rb, x, kk, dils, use_pallas, exact_edge)
            xs = y if xs is None else xs + y
        x = xs / cfg.num_kernels
    x = _act_cm(cfg, params["act_post"], x, use_pallas, exact_edge)
    x = _conv1d_cm(params["conv_post"], x, padding=3)
    return bigvgan.final(cfg, x)[:, 0, :]


def _vocode_window(params: Dict[str, Any], cfg: BigVGANConfig,
                   latent: torch.Tensor, spk: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """Windows (B, W, gpt_dim) + speaker embedding ((1|B), 1, spk_dim), or
    None for the mel vocoder → wav (B, W·upsample) through the
    reference-structured channels-last stages; kernel B3 for every
    activation when ``cfg.use_pallas``."""
    if spk is not None and spk.shape[0] == 1 and latent.shape[0] > 1:
        spk = spk.expand((latent.shape[0],) + spk.shape[1:])
    return bigvgan.generate(params, cfg, latent, spk)


def speaker_embedding(params: Dict[str, Any], mel_ref: torch.Tensor) -> torch.Tensor:
    """mel_ref (B, T, n_mels) → (B, 1, spk_dim)."""
    return ecapa.forward(params["speaker_encoder"], mel_ref)


LAYOUTS = ("cmajor", "ref")


class WindowedVocoder:
    """Vocode latent streams of any length through fixed-size windows in
    batches of power-of-two sizes (largest ≤ ``max_batch`` first).
    ``layout``: "cmajor" (None means it, on every device) or "ref".
    ``use_pallas`` (K1) and ``fuse_resblocks`` (K2) default to on, on every
    device: a wrapper launches its kernel on a CUDA tensor and takes its
    plain version on a CPU one. ``edge_exact`` defaults to ``use_pallas or
    fuse_resblocks`` (JAX ``vocoder.py:399-400``). On "ref" the three
    change nothing."""

    def __init__(self, params: Dict[str, Any], cfg: BigVGANConfig,
                 window: int = 112, halo: int = DEFAULT_HALO,
                 max_batch: int = 32, compute_dtype=torch.float32,
                 layout: Optional[str] = None,
                 use_pallas: Optional[bool] = None,
                 fuse_resblocks: Optional[bool] = None,
                 edge_exact: Optional[bool] = None):
        layout = layout or "cmajor"
        if layout not in LAYOUTS:
            raise ValueError(f"layout {layout!r} is not one of {LAYOUTS}")
        self.layout = layout
        self.params = params
        self.cfg = cfg
        self.device = params["conv_pre"]["w"].device
        self.window = window
        self.halo = halo
        self.max_batch = max_batch
        self.compute_dtype = compute_dtype
        self.upsample = int(np.prod(cfg.upsample_rates))
        self.use_pallas = True if use_pallas is None else use_pallas
        self.fuse_resblocks = (True if fuse_resblocks is None
                               else fuse_resblocks)
        self.edge_exact = (self.use_pallas or self.fuse_resblocks
                           if edge_exact is None else edge_exact)
        self._packed: Dict[Tuple[torch.dtype, bool], Dict[int, Tuple]] = {}

    def speaker_embedding(self, mel_ref: torch.Tensor) -> torch.Tensor:
        return speaker_embedding(self.params, mel_ref)

    def _vocode(self, windows: torch.Tensor, spk: torch.Tensor,
                exact: bool) -> torch.Tensor:
        """One window batch on the layout's window function (JAX
        ``_vocode_fn``). On "cmajor" the switches pick the kernels, and
        ``exact`` asks for the exact route's semantics: the switches'
        kernels in their exact-edge mode, which is the exact route's own
        ops where no kernel runs (both switches off, or a CPU tensor)."""
        if self.layout == "ref":
            return _vocode_window(self.params, self.cfg, windows, spk)
        packed = None
        if self.fuse_resblocks:
            dt = (windows.dtype if spk is None
                  else torch.promote_types(windows.dtype, spk.dtype))
            if (dt, exact) not in self._packed:
                self._packed[dt, exact] = pack_fused_resblocks(
                    self.params, self.cfg, dt, exact_edge=exact)
            packed = self._packed[dt, exact]
        return _vocode_window_cmajor(self.params, self.cfg, windows, spk,
                                    use_pallas=self.use_pallas,
                                    fuse_resblocks=self.fuse_resblocks,
                                    packed=packed, exact_edge=exact)

    def _edge_approx(self) -> bool:
        """True when the windows' route departs from the exact one at a
        true stream boundary (a kernel replicate-pads where the exact route
        zero-pads each conv): the case the edge patches correct."""
        return self.layout == "cmajor" and (self.use_pallas
                                            or self.fuse_resblocks)

    def _whole_span(self, dev):
        """The span of a stream vocoded whole at its own length: the exact
        route's with ``edge_exact``, else the plan's."""
        return (exact_span(dev) if self.edge_exact
                else profiling.span("vocoder.plan", device=dev))

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

    def _collect(self, outs: List[torch.Tensor], chunk,
                 wavs: torch.Tensor) -> None:
        """Write each window's kept frames, ``chunk``'s (row, start, end,
        window_lo), into its row's output ``outs[row]``."""
        up = self.upsample
        for wv, (r, s, e, lo) in zip(wavs, chunk):
            off = s - lo
            outs[r][s * up: e * up] = wv[off * up: (off + e - s) * up]

    def _apply_edge_patches(self, outs: List[torch.Tensor], ends, fetch,
                            spk: Optional[torch.Tensor]) -> None:
        """For each (row, t) of ``ends``, overwrite outs[row][: halo·up] and
        outs[row][(t-halo)·up :] with the exact route's outputs over
        2·halo-frame patches at the stream's two ends, all in one batch;
        each patch keeps its boundary half, whose other edge is ≥ halo from
        every kept sample. ``fetch(row, lo, pw)`` returns the row's latent
        frames [lo, lo+pw) as (pw, C). Only with ``edge_exact`` on a route
        that departs from the exact one at the ends (JAX
        ``vocoder.py:514``)."""
        if not (self.edge_exact and self._edge_approx()) or not ends:
            return
        pw = 2 * self.halo
        hu = self.halo * self.upsample
        dev = outs[ends[0][0]].device
        with exact_span(dev):
            patches = torch.stack([fetch(r, 0, pw) for r, _ in ends]
                                  + [fetch(r, t - pw, pw) for r, t in ends])
            ewav = self._vocode(patches, None if spk is None else spk[:1],
                                exact=True).float()
            for i, (r, t) in enumerate(ends):
                outs[r][:hu] = ewav[i, :hu]
                outs[r][t * self.upsample - hu:] = ewav[len(ends) + i, hu:]

    def stream_rows(self, lat: torch.Tensor, lens: Sequence[int]
                    ) -> List[torch.Tensor]:
        """Vocode each row of ``lat`` (rows, MB, C) as a stream of its own,
        ``lat[r, :lens[r]]``, with no speaker input (the mel vocoder), in one
        static plan whose lengths the host knows, so it reads nothing from
        the device: the windows of every row longer than window + 2·halo
        (``_window_list``, each row's windows clamped inside it) in batches
        (``_plan_batches``); then ``_apply_edge_patches`` at both ends of
        every such row, in one batch; a row no longer than window + 2·halo
        runs whole at its own length (by the exact route with
        ``edge_exact``), with the rows of its length. Returns each row's
        float32 wav (lens[r]·upsample,) on the device."""
        lens = [int(n) for n in lens]
        dev = lat.device
        mb = lat.shape[1]
        flat = lat.to(self.compute_dtype).reshape(-1, lat.shape[-1])
        full = self.window + 2 * self.halo
        outs: List[Optional[torch.Tensor]] = [
            torch.zeros(0, dtype=torch.float32, device=dev) if n == 0
            else None for n in lens]
        rows = [r for r, n in enumerate(lens) if n > full]
        if rows:
            with profiling.span("vocoder.plan", device=dev):
                for r in rows:
                    outs[r] = torch.empty(lens[r] * self.upsample,
                                          dtype=torch.float32, device=dev)
                wins = [(r, s, e, lo) for r in rows
                        for s, e, lo in self._window_list(lens[r])]
                for chunk in self._plan_batches(wins):
                    x = torch.stack([flat[r * mb + lo: r * mb + lo + full]
                                     for r, _, _, lo in chunk])
                    self._collect(outs, chunk,
                                  self._vocode(x, None, exact=False).float())
            self._apply_edge_patches(
                outs, [(r, lens[r]) for r in rows],
                lambda r, lo, pw: flat[r * mb + lo: r * mb + lo + pw], None)
        for n in sorted({n for n in lens if 0 < n <= full}):
            same = [r for r, m in enumerate(lens) if m == n]
            with self._whole_span(dev):
                x = torch.stack([flat[r * mb: r * mb + n] for r in same])
                wavs = self._vocode(x, None, exact=self.edge_exact).float()
            for wv, r in zip(wavs, same):
                outs[r] = wv
        return outs

    def __call__(self, latent, mel_ref=None,
                 spk: Optional[torch.Tensor] = None) -> np.ndarray:
        """Vocode one host stream: latent (T, C) or (1, T, C) → float32 wav
        (T·1024,). It goes to the parameters' device as float32 and takes
        ``stream_device``'s windows, so the two give the same wav."""
        latent = np.asarray(latent, np.float32)
        if latent.ndim == 3:
            latent = latent[0]
        if spk is None:
            spk = self.speaker_embedding(
                torch.as_tensor(mel_ref, device=self.device))
        with profiling.sync("h2d"):
            lat = torch.from_numpy(latent).to(self.device)[None]
        return self.stream_device(lat, [latent.shape[0]], spk=spk)

    def stream_device(self, lat: torch.Tensor, lens, order=None,
                      spk: Optional[torch.Tensor] = None,
                      mel_ref: Optional[torch.Tensor] = None) -> np.ndarray:
        """Vocode the stream concat(lat[order[s], :lens[order[s]]]) that lives
        on the device: lat (rows, MB, C), lens (rows,) host ints. Windows are
        gathered on the device; the stitched float32 wav comes back to the
        host once. A stream no longer than one window runs at its own length,
        all of it boundary: by the exact route with ``edge_exact``, else by
        the switches' kernels (JAX ``vocoder.py:447-455``)."""
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
        with profiling.sync("h2d"):
            flatmap = torch.as_tensor(rows * mb + cols, device=dev)
        full = self.window + 2 * self.halo
        if t <= full:
            with self._whole_span(dev):
                stream = flat[flatmap][None]
                wav = self._vocode(stream, spk[:1], exact=self.edge_exact)[0]
            with profiling.sync("wav"):
                return wav.float().cpu().numpy()
        out = torch.empty(t * self.upsample, dtype=torch.float32, device=dev)
        with profiling.span("vocoder.plan", device=dev):
            wins = [(0, s, e, lo) for s, e, lo in self._window_list(t)]
            for chunk in self._plan_batches(wins):
                idx = torch.stack([flatmap[lo: lo + full]
                                   for (_, _, _, lo) in chunk])
                wavs = self._vocode(flat[idx], spk, exact=False).float()
                self._collect([out], chunk, wavs)
        self._apply_edge_patches(
            [out], [(0, t)], lambda _, lo, pw: flat[flatmap[lo: lo + pw]],
            spk)
        with profiling.sync("wav"):
            return out.cpu().numpy()
