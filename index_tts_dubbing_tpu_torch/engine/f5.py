"""F5-TTS engine: flow-matching TTS on the port's DiT and the C-major mel
vocoder.

One call is one batch of lines in one voice. Each line becomes a row of
its own: the prompt's BigVGAN mel (``ops/mel.BigVGANMel``) and zeros after
it as ``cond``, the prompt's transcript joined to the line's text as
character ids, noise drawn from a seed, and a fixed frame count,
``prompt_frames + int(seconds·24000/256)`` (F5's ``fix_duration``), or
F5's estimate from the texts' UTF-8 lengths when no duration is given.
Rows are padded to the longest; padded keys are masked.

``infer_batch`` then runs the sampler: ``nfe_step`` Euler steps over the
sway-sampled time grid ``t = linspace(0, 1, nfe + 1)``, ``t += s·(cos(πt/2)
- 1 + t)``, each one guided DiT forward (models/dit.py) over the
conditioned rows and the unconditioned ones (cond and text dropped) as one
batch of twice the rows, ``v = v_c + cfg·(v_c - v_u)``, ``x += Δt·v``
(the loop IndexTTS-2's S2M shares, engine/ode.py). The
prompt's frames are restored from ``cond``, the generated frames of every
row go through the mel vocoder's window plan
(``WindowedVocoder.stream_rows``: K1 and K2, exact patches at each line's
ends, a line under window + 2·halo frames by the exact route), and the
wav is scaled back by the prompt's loudness as F5 does, then emitted as
int16 on the device.

Departures from F5-TTS's ``infer_process``: one line is one row (no text
chunking, no cross-fade); the prompt is not trimmed or padded with
silence; without a ``vocab.txt`` a character's id is its code point modulo
the vocabulary size; row i of a batch draws its noise from the call's
seed plus i (F5 reseeds every row with the one seed); the ODE state, the time grid and
the guidance run in float32 whatever the DiT's dtype (F5 runs them in the
model's half precision).

Spans (utils/profiling.py): the call is a ``request`` (attributes
``entry``, ``rows``: the guided rows, ``frames``: rows × padded frames,
``real_frames``, ``nfe``), with ``front`` (host), ``cond`` (the prompt's
mel), ``f5.text`` (the text encoder, once a call), ``f5.ode`` (the whole
loop) holding one ``f5.nfe`` a step (attribute ``step``), the vocoder's
``vocoder.plan`` and ``vocoder.exact``, and ``sync`` at each host wait.
``last_times`` (``F5Times``) holds the call's host seconds of the ODE and
of the vocoder.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.config import F5Config
from index_tts_dubbing_tpu_torch.engine.ode import guided_euler, row_noise
from index_tts_dubbing_tpu_torch.engine.vocoder import (WindowedVocoder,
                                                        receptive_frames)
from index_tts_dubbing_tpu_torch.models import dit
from index_tts_dubbing_tpu_torch.ops.mel import BigVGANMel
from index_tts_dubbing_tpu_torch.utils import audio as audio_util
from index_tts_dubbing_tpu_torch.utils import profiling


# the settings a call may give (F5-TTS's ``infer`` takes them per call)
SAMPLER_KEYS = {"nfe_step", "cfg_strength", "sway_sampling_coef"}


@dataclass
class F5Times:
    ode: float = 0.0            # text encoder and the ODE, host seconds
    bigvgan: float = 0.0        # the vocoder and the int16 emission
    total: float = 0.0
    audio_seconds: float = 0.0
    nfe: int = 0                # guided DiT forwards

    @property
    def rtf(self) -> float:
        return self.total / max(self.audio_seconds, 1e-9)


def sway_grid(nfe: int, coef: float, device) -> torch.Tensor:
    """F5's time grid: (nfe + 1,) float32 from 0 to 1, sway-sampled."""
    t = torch.linspace(0.0, 1.0, nfe + 1, device=device)
    return t + coef * (torch.cos(torch.pi / 2 * t) - 1 + t)


def join_texts(ref_text: str, text: str) -> str:
    """F5's prompt transcript joined to the line: the transcript ends in
    ". " (or "。"), or gains " " after a final '.'."""
    if not (ref_text.endswith(". ") or ref_text.endswith("。")):
        ref_text += " " if ref_text.endswith(".") else ". "
    return ref_text + text


class F5TTS:
    """F5-TTS Base on ``device`` ("cuda" unless the caller says): the DiT in
    bfloat16 with ``is_fp16``, else float32; the vocoder in float32.

    ``params``: the port's tree ({"dit", "vocoder"}, as
    ``weights.init_f5`` gives it); without it, random weights from
    ``seed``. A character's id is its code point modulo
    ``text_num_embeds`` (the checkpoint's ``vocab.txt`` is not in the
    repository). The vocoder's window plan takes the halo
    ``receptive_frames`` derives for the ×256 chain.

    After each call: ``last_times`` (F5Times), ``last_mel`` (rows, N, M)
    float32 on the device (the sampled mel, prompt frames restored),
    ``last_noise`` (the same shape: the ODE's start, zero past each row),
    ``last_frames`` (each row's frames), ``last_prompt_frames``.
    """

    def __init__(self, config: Optional[F5Config] = None,
                 params: Optional[Dict[str, Any]] = None,
                 is_fp16: bool = False, device=None, seed: int = 0,
                 vocoder_window: int = 112, verbose_init: bool = True):
        self.device = torch.device(device if device is not None else "cuda")
        self.cfg = config if config is not None else F5Config()
        if self.cfg.dit.text_mask_padding:
            raise NotImplementedError(
                "text_mask_padding (F5-TTS v1's text masking) is not "
                "ported; F5TTS_Base runs without it")
        self.dtype = torch.bfloat16 if is_fp16 else torch.float32
        if params is None:
            gen = torch.Generator(self.device).manual_seed(seed)
            params = weights.init_f5(self.cfg, gen, self.device)
        self.params = {
            "dit": weights.from_jax_params(params["dit"], self.device,
                                           self.dtype),
            "vocoder": weights.from_jax_params(params["vocoder"],
                                               self.device, torch.float32)}
        m = self.cfg.mel
        self.mel_fn = BigVGANMel(
            sample_rate=m.sample_rate, n_fft=m.n_fft, hop_length=m.hop_length,
            win_length=m.win_length, n_mels=m.n_mels, f_min=m.mel_fmin,
            device=self.device)
        self.vocoder = WindowedVocoder(
            self.params["vocoder"], self.cfg.vocoder, window=vocoder_window,
            halo=max(receptive_frames(self.cfg.vocoder)),
            compute_dtype=torch.float32)
        self._seeds = np.random.default_rng(seed)
        self._prompt_key = None
        self._prompt: Optional[Tuple[torch.Tensor, float]] = None
        if verbose_init:
            print(f">> F5-TTS: DiT in {self.dtype}, vocoder halo "
                  f"{self.vocoder.halo} frames")

    # -- front ---------------------------------------------------------
    def text_ids(self, text: str) -> List[int]:
        """Characters → vocabulary indices: code points modulo the
        vocabulary's size."""
        return [ord(c) % self.cfg.dit.text_num_embeds for c in text]

    def frames(self, seconds: float) -> int:
        m = self.cfg.mel
        return int(seconds * m.sample_rate / m.hop_length)

    def prompt_mel(self, audio_prompt) -> Tuple[torch.Tensor, float]:
        """(prompt frames, M) float32 on the device, of the prompt at F5's
        loudness (raised to ``target_rms`` where quieter), and the prompt's
        own RMS; cached per prompt."""
        if self._prompt is None or self._prompt_key != audio_prompt:
            wav = audio_util.load_audio_mean_mono(audio_prompt,
                                                  self.cfg.mel.sample_rate)
            wav = np.asarray(wav, np.float32)[0]
            rms = float(np.sqrt(np.mean(np.square(wav, dtype=np.float64))))
            if rms < self.cfg.target_rms:
                wav = wav * (self.cfg.target_rms / rms)
            with profiling.span("cond", device=self.device):
                mel = self.mel_fn(wav)[0].transpose(0, 1).contiguous()
            self._prompt, self._prompt_key = (mel, rms), audio_prompt
        return self._prompt

    def durations(self, prompt_frames: int, ref_text: str,
                  texts: Sequence[str], seconds: Sequence[Optional[float]]
                  ) -> List[int]:
        """Each row's frames: the prompt's plus the line's fixed duration,
        or F5's estimate from the texts' UTF-8 lengths; at least the text's
        ids and the prompt's frames plus one (``CFM.sample``)."""
        out = []
        ref_bytes = max(len(ref_text.encode("utf-8")), 1)
        for text, sec in zip(texts, seconds):
            gen = (self.frames(sec) if sec is not None else
                   int(prompt_frames / ref_bytes * len(text.encode("utf-8"))))
            n_ids = len(join_texts(ref_text, text))
            out.append(max(prompt_frames + gen, n_ids + 1, prompt_frames + 1))
        return out

    # -- the sampler ---------------------------------------------------
    def draw_noise(self, durs: Sequence[int], n: int, seed: int
                   ) -> torch.Tensor:
        """The ODE's start, (rows, n, M) float32 on the device: row i's
        first durs[i] frames N(0, 1) from a generator on the device seeded
        with ``seed + i``, as (durs[i], M); zeros past them."""
        return row_noise(durs, n, self.cfg.dit.mel_dim, seed, self.device)

    def sample(self, cond: torch.Tensor, ids: List[List[int]],
               durs: List[int], seed: int, times: F5Times,
               cfg: Optional[F5Config] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The guided Euler ODE over len(durs) rows: cond (Tp, M) the prompt
        mel, ``ids`` each row's character ids, ``durs`` its frames; row i's
        noise N(0, 1) from the seed ``seed + i``; the sampler's settings
        ``cfg``'s (None: the engine's). Returns (the sampled mel with the
        prompt restored, the noise it started from), each (rows, N, M)
        float32."""
        cfg, dev = cfg or self.cfg, self.device
        dcfg, p = cfg.dit, self.params["dit"]
        b, n, m = len(durs), max(durs), dcfg.mel_dim
        tp = cond.shape[0]
        host = np.zeros((b, n + 1), np.int64)
        for i, (row, d) in enumerate(zip(ids, durs)):
            row = row[:d]
            host[i, : len(row)] = np.asarray(row, np.int64) + 1
            host[i, n] = d
        with profiling.sync("h2d"):
            dev_host = torch.as_tensor(host, device=dev)
        ids_t, lens = dev_host[:, :n], dev_host[:, n]
        noise = self.draw_noise(durs, n, seed)
        step_cond = torch.zeros((b, n, m), dtype=torch.float32, device=dev)
        step_cond[:, :tp] = cond
        ragged = len(set(durs)) > 1
        lens2 = torch.cat([lens, lens])
        valid2 = dit.valid_mask(lens2, n) if ragged else None
        with profiling.span("f5.text", device=dev):
            text2 = dit.text_encoder(
                p["text"], dcfg, torch.cat([ids_t, torch.zeros_like(ids_t)]),
                lens2, self.dtype)
            cond2 = torch.cat([step_cond, torch.zeros_like(step_cond)])
        grid = sway_grid(cfg.nfe_step, cfg.sway_sampling_coef, dev)
        dts = grid[1:] - grid[:-1]
        blocks, final = dit.modulations(
            p, dit.time_embed(p["time"], dcfg, grid[:-1], self.dtype))
        rope = dit.rotary(n, dcfg.dim_head, dev)

        def velocity(s, xx):
            mods = ([mb[s: s + 1] for mb in blocks], final[s: s + 1])
            return dit.forward(p, dcfg, xx, cond2, text2, mods, valid2, rope)

        with profiling.span("f5.ode", device=dev):
            x = guided_euler(noise, dts, velocity, cfg.cfg_strength,
                             "f5.nfe")
            times.nfe += cfg.nfe_step
            keep = (torch.arange(n, device=dev) < tp)[None, :, None]
            out = torch.where(keep, step_cond, x)
        return out, noise

    # -- public entry points ---------------------------------------------
    def infer_batch(self, audio_prompt, ref_text: str, texts: Sequence[str],
                    seconds_each: Optional[Sequence[Optional[float]]] = None,
                    seed: Optional[int] = None, verbose: bool = False,
                    **sampler) -> List[Tuple[int, np.ndarray]]:
        """Every line of ``texts`` in one batch of rows (twice as many
        rows a DiT forward), each at its ``seconds_each`` duration (None:
        F5's estimate). Line i's noise comes from the seed ``seed + i``, so
        it is what ``infer(..., seed=seed + i)`` draws for that line alone
        (None: a seed from the engine's own draws). ``sampler``: F5's
        ``nfe_step``, ``cfg_strength`` and ``sway_sampling_coef`` for this
        call (the configuration's where absent). Returns [(sample_rate,
        int16 (T, 1))] per line."""
        with profiling.span("request", entry="infer_batch") as sp:
            return self._infer_batch(sp, audio_prompt, ref_text, list(texts),
                                     seconds_each, seed, verbose, sampler)

    def infer(self, audio_prompt, ref_text: str, text: str,
              seconds: Optional[float] = None, seed: Optional[int] = None,
              verbose: bool = False, **sampler) -> Tuple[int, np.ndarray]:
        """One line: (sample_rate, int16 (T, 1))."""
        with profiling.span("request", entry="infer") as sp:
            return self._infer_batch(sp, audio_prompt, ref_text, [text],
                                     [seconds], seed, verbose, sampler)[0]

    def _infer_batch(self, sp, audio_prompt, ref_text, texts, seconds_each,
                     seed, verbose, sampler) -> List[Tuple[int, np.ndarray]]:
        start = time.perf_counter()
        times = F5Times()
        unknown = set(sampler) - SAMPLER_KEYS
        if unknown:
            raise TypeError(f"unknown sampler settings {sorted(unknown)}")
        cfg = replace(self.cfg, **{k: v for k, v in sampler.items()
                                   if v is not None})
        sr, up = self.cfg.mel.sample_rate, self.vocoder.upsample
        if seconds_each is None:
            seconds_each = [None] * len(texts)
        if len(seconds_each) != len(texts):
            raise ValueError(f"{len(texts)} texts, {len(seconds_each)} "
                             f"durations")
        cond, rms = self.prompt_mel(audio_prompt)
        tp = cond.shape[0]
        with profiling.span("front"):
            ids = [self.text_ids(join_texts(ref_text, t)) for t in texts]
            durs = self.durations(tp, ref_text, texts, seconds_each)
        n = max(durs)
        sp.set(rows=2 * len(durs), frames=2 * len(durs) * n,
               real_frames=2 * sum(durs), nfe=cfg.nfe_step)
        with profiling.stage(times, "ode"):
            if seed is None:
                seed = int(self._seeds.integers(2**62))
            out, noise = self.sample(cond, ids, durs, int(seed), times, cfg)
            if self.device.type == "cuda":   # so the clock covers the ODE
                with profiling.sync("synchronize"):
                    torch.cuda.synchronize(self.device)
        gen = [d - tp for d in durs]
        with profiling.stage(times, "bigvgan"):
            wavs = self.vocoder.stream_rows(out[:, tp:], gen)
            scale = (rms / self.cfg.target_rms
                     if rms < self.cfg.target_rms else 1.0)
            i16 = (torch.cat(wavs) * (scale * 32767.0)).clamp(
                -32767.0, 32767.0).to(torch.int16)
            with profiling.sync("wav"):
                i16 = i16.cpu().numpy()
        bounds = np.concatenate([[0], np.cumsum(gen)]) * up
        outs = [(sr, i16[bounds[i]: bounds[i + 1], None])
                for i in range(len(gen))]
        times.total = time.perf_counter() - start
        times.audio_seconds = i16.size / sr
        self.last_times, self.last_mel, self.last_noise = times, out, noise
        self.last_frames, self.last_prompt_frames = durs, tp
        if verbose:
            print(f">> F5-TTS: {len(gen)} lines, {2 * len(gen)} rows of "
                  f"{n} frames, {times.nfe} guided forwards; ode "
                  f"{times.ode:.2f} s, vocoder {times.bigvgan:.2f} s, RTF "
                  f"{times.rtf:.4f}")
        return outs

