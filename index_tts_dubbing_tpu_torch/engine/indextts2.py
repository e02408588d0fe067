"""IndexTTS-2 engine: duration-free AR semantic codes, then flow-matching
mel, then BigVGAN-v2 22 kHz.

A call follows index-tts's ``indextts/infer_v2.py``:

1. the voice: the prompt at 22 050 Hz, its 80-band BigVGAN mel, 16 kHz by
   torchaudio's sinc resampler (ops/fbank.py), w2v-BERT 2.0's hidden state
   17 normalised (models/w2vbert.py), the semantic codec's quantized
   embeddings of it (models/semantic_codec.py), CAM++'s 192-d style of the
   Kaldi fbank (models/campplus.py) and the regulated prompt condition
   (models/s2m.py); cached per prompt, as ``infer_v2.py`` caches it;
2. the text: the port's tokenizer (utils/front.py, 12 000 tokens; the
   character fallback without a BPE model), each line split into segments
   at its sentence marks;
3. the GPT's conditioning rows: the speaker conditioner's 32 latents plus
   the emotion vector (``merge_emovec`` of the speaker prompt with itself,
   ``emo_alpha`` 1: IndexTTS-2's default with no emotion prompt), then the
   duration embedding's rows 1 and 0 (models/gpt.py ``v2_conds``); cached
   per prompt;
4. the beam-sampled semantic codes (engine/decode.py, the "anc" route: on a
   card each step after the first a CUDA graph's replay and its attention
   kernel K3), the warpers on each step's log-probabilities
   (``SamplingConfig.warp_each_step``: the transformers release IndexTTS-2
   pins), each row cut at its first stop;
5. the latent pass over [conds · text · codes] (models/gpt.py);
6. ``gpt_layer`` of the latents plus the codec's ``vq2emb`` of the codes,
   regulated to ``int(codes · 1.72)`` mel frames, after the prompt's
   condition;
7. the S2M DiT's guided Euler ODE (engine/ode.py, ``diffusion_steps`` 25,
   ``inference_cfg_rate`` 0.7) over every row of the call as one batch:
   noise N(0, 1), the prompt's mel in ``prompt_x``, the prompt frames of x
   held at zero after every step; the unconditioned rows drop the prompt
   mel, the condition and the style;
8. the prompt frames cut off; 9. BigVGAN-v2 ×256 on K1/K2 through the
   mel vocoder's per-line plan (``WindowedVocoder.stream_rows``); 10. the
   wav scaled to int16 on the device.

Departures from ``infer_v2.py``: the segments of every line of a call
decode as one batch of beam rows, and go through S2M as one padded batch
(each row its own noise, from the call's seed plus its place); a line's
segments are joined with no silence between them; w2v-BERT runs only the
17 layers whose output is read; the prompt is read at 22 050 Hz by the
port's resampler (scipy's polyphase filter where ``librosa.load`` uses
soxr); an odd fbank frame count drops its last frame; the Euler loop
steps the uniform grid as F5's loop does (``Δt`` from the grid, not a
running ``t``) and guides as ``v_c + (v_c − v_u)·cfg`` (the published
``(1 + cfg)·v_c − cfg·v_u``); the front end runs once per prompt in
float32 with TF32 off. The checkpoint loader, the emotion matrices behind
``emo_vector`` and the text-to-emotion model are not ported.

Spans (utils/profiling.py): the call is a ``request`` (attributes
``entry``, ``rows``: beam rows, ``decode_steps``, ``s2m_rows``: guided
rows, ``s2m_frames``: those rows × padded frames, ``real_frames``,
``nfe``, ``graph_captures``) holding ``v2.voice`` (the front end, attribute
``cached``), ``front`` (host), ``v2.cond`` (the conditioners and the
prefix), ``decode.prefill``, ``decode.step``, ``latent``, ``s2m.regulate``,
``s2m.ode`` with one ``s2m.nfe`` a step (attribute ``step``), the
vocoder's ``vocoder.plan`` and ``vocoder.exact``, and ``sync`` at each host
wait. ``last_times`` (``V2Times``) holds the call's host seconds.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.config import IndexTTS2Config
from index_tts_dubbing_tpu_torch.engine import decode as decode_mod
from index_tts_dubbing_tpu_torch.engine.decode import SamplingConfig
from index_tts_dubbing_tpu_torch.engine.ode import guided_euler, row_noise
from index_tts_dubbing_tpu_torch.engine.tts import CharTokenizer
from index_tts_dubbing_tpu_torch.engine.vocoder import (WindowedVocoder,
                                                        receptive_frames)
from index_tts_dubbing_tpu_torch.models import (campplus, gpt as gpt_model,
                                                s2m, semantic_codec, w2vbert)
from index_tts_dubbing_tpu_torch.ops import fbank
from index_tts_dubbing_tpu_torch.ops.mel import BigVGANMel
from index_tts_dubbing_tpu_torch.utils import audio as audio_util
from index_tts_dubbing_tpu_torch.utils import profiling
from index_tts_dubbing_tpu_torch.utils.front import (TextNormalizer,
                                                     TextTokenizer)

# IndexTTS-2's generation defaults (infer_v2.py)
GENERATION = dict(do_sample=True, top_p=0.8, top_k=30, temperature=0.8,
                  length_penalty=0.0, num_beams=3, repetition_penalty=10.0,
                  max_mel_tokens=1500)
SEGMENT_TOKENS = 120


@dataclass
class V2Times:
    gpt_gen: float = 0.0        # conditioning, prefix, decode, latent pass
    s2m: float = 0.0            # gpt_layer, regulator and the ODE
    bigvgan: float = 0.0        # the vocoder and the int16 emission
    total: float = 0.0
    audio_seconds: float = 0.0
    decode_steps: int = 0
    nfe: int = 0

    @property
    def rtf(self) -> float:
        return self.total / max(self.audio_seconds, 1e-9)


def code_lengths(codes: np.ndarray, stop: int) -> List[int]:
    """Each row's codes before its first stop (infer_v2's cut)."""
    out = []
    for row in codes:
        stops = np.nonzero(row == stop)[0]
        out.append(int(stops[0]) if stops.size else int(row.size))
    return out


def mel_frames(n_codes: int, per_code: float) -> int:
    """``(code_len · 1.72).long()`` as torch computes it in float32."""
    return int(np.float32(n_codes) * np.float32(per_code))


class IndexTTS2:
    """IndexTTS-2 on ``device`` ("cuda" unless the caller says): the GPT
    and the S2M DiT in bfloat16 with ``is_fp16`` (their norms, the ODE
    state and the guidance in float32), else float32; the front end and the
    vocoder in float32.

    ``params``: the port's tree (``weights.indextts2_tree``'s layout);
    without it, random weights from ``seed``. ``model_dir``: a directory
    whose ``bpe.model`` the tokenizer reads (the character fallback
    without one); the checkpoints are not loaded.

    After each call: ``last_times`` (V2Times), ``last_raw_codes`` (the
    decode's rows, host), ``last_codes`` (each row's served codes, cut at
    its stop), ``last_mel`` (rows, N, 80) float32 on the
    device (the sampled mel, prompt frames zero), ``last_noise`` (the ODE's
    start, as drawn), ``last_frames`` (each row's frames, prompt
    included), ``last_prompt_frames``, ``last_rows`` (each row's line).
    """

    def __init__(self, config: Optional[IndexTTS2Config] = None,
                 params: Optional[Dict[str, Any]] = None,
                 is_fp16: bool = False, device=None, seed: int = 0,
                 model_dir: Optional[str] = None, vocoder_window: int = 112,
                 verbose_init: bool = True):
        self.device = torch.device(device if device is not None else "cuda")
        self.cfg = config if config is not None else IndexTTS2Config()
        self.gcfg = self.cfg.gpt
        self.dtype = torch.bfloat16 if is_fp16 else torch.float32
        if params is None:
            gen = torch.Generator(self.device).manual_seed(seed)
            params = weights.init_indextts2(self.cfg, gen, self.device)
        f32 = torch.float32
        self.params = {k: weights.from_jax_params(
            params[k], self.device, self.dtype if k in ("gpt", "s2m") else f32)
            for k in ("gpt", "w2vbert", "codec", "campplus", "s2m",
                      "vocoder")}
        m = self.cfg.mel
        self.mel_fn = BigVGANMel(
            sample_rate=m.sample_rate, n_fft=m.n_fft, hop_length=m.hop_length,
            win_length=m.win_length, n_mels=m.n_mels, f_min=m.mel_fmin,
            device=self.device)
        self.vocoder = WindowedVocoder(
            self.params["vocoder"], self.cfg.vocoder, window=vocoder_window,
            halo=max(receptive_frames(self.cfg.vocoder)),
            compute_dtype=torch.float32)
        normalizer = TextNormalizer()
        normalizer.load()
        bpe = None if model_dir is None else os.path.join(model_dir,
                                                           "bpe.model")
        self.tokenizer = (TextTokenizer(bpe, normalizer)
                          if bpe and os.path.exists(bpe) else
                          CharTokenizer(self.gcfg.number_text_tokens,
                                        normalizer))
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self._seeds = np.random.default_rng(seed)
        self._beam_workspaces = decode_mod.BeamWorkspaces()
        self._voice_key = None
        self._voice: Optional[SimpleNamespace] = None
        if verbose_init:
            print(f">> IndexTTS-2: GPT and DiT in {self.dtype}, vocoder "
                  f"halo {self.vocoder.halo} frames")

    # -- the voice --------------------------------------------------------
    def voice(self, audio_prompt) -> SimpleNamespace:
        """The prompt's front end, cached per prompt: ``feats`` (w2v-BERT's
        normalised hidden state (1, T, 1024)), ``ref_mel`` (Tp, 80),
        ``style`` (1, 192), ``prompt_cond`` (Tp, 512: the regulated
        quantized embeddings of ``feats``) and ``conds`` (the GPT's
        conditioning rows, made by ``conds``)."""
        cached = self._voice is not None and self._voice_key == audio_prompt
        with profiling.span("v2.voice", device=self.device,
                            cached=int(cached)):
            if not cached:
                self._voice = self._front(audio_prompt)
                self._voice_key = audio_prompt
        return self._voice

    def _front(self, audio_prompt) -> SimpleNamespace:
        cfg, dev, p = self.cfg, self.device, self.params
        wav = audio_util.load_audio_mean_mono(audio_prompt,
                                              cfg.mel.sample_rate)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            wav22 = torch.as_tensor(np.asarray(wav, np.float32)[0],
                                    device=dev)
            wav16 = fbank.resample(wav22, cfg.mel.sample_rate,
                                   cfg.semantic_rate)
            feats = w2vbert.encode(p["w2vbert"], cfg.w2vbert,
                                   fbank.w2vbert_features(wav16))
            s_ref, _ = semantic_codec.quantize(p["codec"], feats)
            ref_mel = self.mel_fn(wav22)[0].transpose(0, 1).contiguous()
            style = campplus.forward(p["campplus"], cfg.campplus,
                                     fbank.campplus_features(wav16)[None])
            tp = ref_mel.shape[0]
            prompt_cond = s2m.regulate(p["s2m"]["regulator"], [s_ref[0]],
                                       [tp])[0][0]
        return SimpleNamespace(feats=feats, ref_mel=ref_mel, style=style,
                               prompt_cond=prompt_cond, conds=None)

    def conds(self, v: SimpleNamespace) -> torch.Tensor:
        """The voice's GPT conditioning rows (1, 34, C): the speaker
        latents plus the emotion vector, then the duration rows."""
        if v.conds is None:
            g, p = self.gcfg, self.params["gpt"]
            f = v.feats.float()
            lens = torch.tensor([f.shape[1]], device=self.device)
            spk = gpt_model.get_conditioning(p, g, f, lens)
            emo = gpt_model.emotion_vector(p, f, self.cfg.emo_attention_heads)
            v.conds = gpt_model.v2_conds(p, spk.to(self.dtype),
                                         emo.to(self.dtype))
        return v.conds

    # -- text -------------------------------------------------------------
    def segments(self, text: str) -> List[np.ndarray]:
        """A line's token-id rows, one per segment (at most
        ``SEGMENT_TOKENS`` tokens each, cut at sentence marks)."""
        toks = self.tokenizer.tokenize(text)
        rows = [np.asarray(self.tokenizer.convert_tokens_to_ids(s), np.int64)
                for s in self.tokenizer.split_sentences(toks, SEGMENT_TOKENS)]
        rows = [r[: self.gcfg.max_text_tokens] for r in rows if r.size]
        return rows or [np.asarray([self.gcfg.stop_text_token], np.int64)]

    # -- stages -------------------------------------------------------------
    def _workspaces(self, num_beams: int
                    ) -> Optional[decode_mod.BeamWorkspaces]:
        return (self._beam_workspaces if self.device.type == "cuda"
                and num_beams > 1 else None)

    def _t2s(self, v, rows: List[np.ndarray], gen: Dict[str, Any],
             times: V2Times) -> Tuple[List[np.ndarray], torch.Tensor]:
        """Beam-sampled codes of every row, cut at their stops, and the
        latent pass: (codes per row on the host, latents (B, M, C))."""
        g, p, dev = self.gcfg, self.params["gpt"], self.device
        nb = int(gen["num_beams"])
        sc = SamplingConfig(do_sample=bool(gen["do_sample"]),
                            temperature=float(gen["temperature"]),
                            top_k=int(gen["top_k"]), top_p=float(gen["top_p"]),
                            repetition_penalty=float(
                                gen["repetition_penalty"]),
                            max_mel_tokens=min(int(gen["max_mel_tokens"]),
                                               g.max_mel_tokens),
                            warp_each_step=True)
        with profiling.span("v2.cond", device=dev):
            conds = self.conds(v)
            pre = decode_mod.prepare_prefix_host(g, rows,
                                                 cond_n=conds.shape[1])
            with profiling.sync("h2d"):
                t = {k: torch.as_tensor(pre[k].astype(np.int64), device=dev)
                     for k in ("ids", "pos", "seg", "cond_idx")}
        with profiling.span("decode.prefill", device=dev):
            emb, keep = decode_mod.build_prefix_emb(
                p, g, conds, t["ids"], t["pos"], t["seg"], t["cond_idx"])
        args = (p, g, sc, emb, keep)
        kw = dict(num_beams=nb, length_penalty=float(gen["length_penalty"]),
                  workspaces=self._workspaces(nb))
        if nb > 1 and sc.do_sample:
            res = decode_mod.generate_beam_sample(*args, self._generator,
                                                  **kw)
        elif nb > 1:
            res = decode_mod.generate_beam(*args, **kw)
        else:
            res = decode_mod.generate(*args, self._generator)
        with profiling.sync("codes"):
            codes = res.codes.cpu().numpy()
        self.last_raw_codes = codes
        times.decode_steps += int(res.steps)
        lens = code_lengths(codes, g.stop_mel_token)
        served = [codes[i, :n].astype(np.int64) for i, n in enumerate(lens)]
        return served, self._latents(conds, rows, served)

    def _latents(self, conds: torch.Tensor, rows: List[np.ndarray],
                 served: List[np.ndarray]) -> torch.Tensor:
        """The latent pass over [conds · text · codes] of each row, text
        and codes padded as ``forward_latent_bucketed`` masks them:
        (B, M, C)."""
        g, p, dev = self.gcfg, self.params["gpt"], self.device
        b = len(rows)
        lens = [c.size for c in served]
        lt = max(r.size for r in rows)
        mb = max(max(lens), 1)
        text = np.full((b, lt), g.stop_text_token, np.int64)
        cpad = np.full((b, mb), g.stop_mel_token, np.int64)
        for i, (r, c) in enumerate(zip(rows, served)):
            text[i, : r.size] = r
            cpad[i, : c.size] = c
        with profiling.span("latent", device=dev):
            with profiling.sync("h2d"):
                d = lambda a: torch.as_tensor(a, device=dev)
                tl = d(np.asarray([r.size for r in rows], np.int64))
                cl = d(np.asarray(lens, np.int64))
                text_t, codes_t = d(text), d(cpad)
            return gpt_model.forward_latent_bucketed(
                p, g, conds.expand((b,) + conds.shape[1:]), text_t, tl,
                codes_t, cl)

    def draw_noise(self, durs: Sequence[int], n: int, seed: int
                   ) -> torch.Tensor:
        """The ODE's start (rows, n, 80) float32: row i's first durs[i]
        frames N(0, 1) from a generator on the device seeded with
        ``seed + i``, as (durs[i], 80); zeros past them."""
        return row_noise(durs, n, self.cfg.s2m.in_channels, seed,
                         self.device)

    def _s2m(self, v, served: List[np.ndarray], lat: torch.Tensor,
             seed: int, times: V2Times
             ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
        """The mel of each row with codes: (mel (B, N, 80), noise, each
        row's frames), B the rows with codes."""
        cfg, sc, dev = self.cfg, self.cfg.s2m, self.device
        p = self.params["s2m"]
        tp = v.ref_mel.shape[0]
        rows = [i for i, c in enumerate(served) if c.size]
        gen = [mel_frames(served[i].size, cfg.frames_per_code) for i in rows]
        if not rows:
            empty = torch.zeros((0, tp, sc.in_channels), device=dev)
            return empty, empty, []
        with profiling.span("s2m.regulate", device=dev):
            lat_rows = s2m.gpt_layer(p["gpt_layer"], lat[rows])
            with profiling.sync("h2d"):
                codes = [torch.as_tensor(served[i], device=dev) for i in rows]
            feats = [semantic_codec.vq2emb(self.params["codec"], c[None])[0]
                     + lat_rows[j, : c.numel()]
                     for j, c in enumerate(codes)]
            cond, _ = s2m.regulate(p["regulator"], feats, gen)
            durs = [tp + y for y in gen]
            b, n = len(rows), max(durs)
            mu = torch.zeros((b, n, sc.content_dim), device=dev)
            mu[:, :tp] = v.prompt_cond
            for j, y in enumerate(gen):
                mu[j, tp: tp + y] = cond[j, :y]
            prompt_x = torch.zeros((b, n, sc.in_channels), device=dev)
            prompt_x[:, :tp] = v.ref_mel
            style = v.style.expand(b, -1)
            # the unconditioned rows drop the prompt, the condition, the style
            with_null = lambda t: torch.cat([t, torch.zeros_like(t)])
            const2 = s2m.merge_const(p["dit"], sc, with_null(prompt_x),
                                     with_null(mu), with_null(style))
            noise = self.draw_noise(durs, n, seed)
            grid = torch.linspace(0.0, 1.0, cfg.diffusion_steps + 1,
                                  device=dev)
            mods = s2m.modulations(p, sc, grid[:-1])
            rope = s2m.rotary(n, sc.hidden_dim // sc.num_heads, dev,
                              sc.rope_base)
            ragged = len(set(durs)) > 1
            valid2 = pad_idx = None
            if ragged:
                lens2 = durs + durs
                valid2 = (torch.arange(n, device=dev)[None]
                          < torch.as_tensor(lens2, device=dev)[:, None])
                pad_idx = s2m.reflect_index(lens2, n, s2m.wavenet_pad(sc),
                                            dev)
            hold = (torch.arange(n, device=dev) < tp)[None, :, None]

        def velocity(s, xx):
            return s2m.forward(p, sc, xx, const2, s2m.step_mods(mods, s),
                               valid2, rope, pad_idx)

        with profiling.span("s2m.ode", device=dev):
            x = guided_euler(noise.masked_fill(hold, 0.0),
                             grid[1:] - grid[:-1], velocity, cfg.cfg_rate,
                             "s2m.nfe", hold=lambda x: x.masked_fill(hold, 0.0))
            times.nfe += cfg.diffusion_steps
        return x, noise, durs

    # -- public entry points ------------------------------------------------
    def infer_batch(self, audio_prompt, texts: Sequence[str],
                    seed: Optional[int] = None, verbose: bool = False,
                    **generation) -> List[Tuple[int, np.ndarray]]:
        """Every line of ``texts`` in one call: their segments decoded as
        one batch of beam rows, then one S2M batch and the vocoder's
        per-line plan. ``generation``: IndexTTS-2's settings
        (``GENERATION``: ``max_mel_tokens``, ``num_beams``, ``top_k``, ...)
        for this call. Row i's ODE noise comes from ``seed + i`` (None: a
        seed from the engine's own draws). Returns [(22050, int16 (T, 1))]
        per line."""
        with profiling.span("request", entry="infer_batch") as sp:
            return self._infer_batch(sp, audio_prompt, list(texts), seed,
                                     verbose, generation)

    def infer(self, audio_prompt, text: str, seed: Optional[int] = None,
              verbose: bool = False, **generation) -> Tuple[int, np.ndarray]:
        """One line: (22050, int16 (T, 1))."""
        with profiling.span("request", entry="infer") as sp:
            return self._infer_batch(sp, audio_prompt, [text], seed, verbose,
                                     generation)[0]

    def _infer_batch(self, sp, audio_prompt, texts, seed, verbose,
                     generation) -> List[Tuple[int, np.ndarray]]:
        start = time.perf_counter()
        unknown = set(generation) - set(GENERATION)
        if unknown:
            raise TypeError(f"unknown generation settings {sorted(unknown)}")
        gen = dict(GENERATION, **{k: v for k, v in generation.items()
                                  if v is not None})
        times = V2Times()
        n0 = self._beam_workspaces.captures
        v = self.voice(audio_prompt)
        with profiling.span("front"):
            segs = [self.segments(t) for t in texts]
            rows = [r for s in segs for r in s]
            line_of = [i for i, s in enumerate(segs) for _ in s]
        with profiling.stage(times, "gpt_gen"):
            served, lat = self._t2s(v, rows, gen, times)
        if seed is None:
            seed = int(self._seeds.integers(2**62))
        tp = v.ref_mel.shape[0]
        with profiling.stage(times, "s2m"):
            mel, noise, durs = self._s2m(v, served, lat, int(seed), times)
            if self.device.type == "cuda":   # so the clock covers the ODE
                with profiling.sync("synchronize"):
                    torch.cuda.synchronize(self.device)
        gen_frames = [d - tp for d in durs]
        with profiling.stage(times, "bigvgan"):
            wavs = self.vocoder.stream_rows(mel[:, tp:], gen_frames)
            i16 = (torch.cat(wavs) * 32767.0).clamp(
                -32767.0, 32767.0).to(torch.int16)
            with profiling.sync("wav"):
                i16 = i16.cpu().numpy()
        up, sr = self.vocoder.upsample, self.cfg.mel.sample_rate
        with_codes = [i for i, c in enumerate(served) if c.size]
        per_row = [np.zeros(0, np.int16)] * len(rows)
        bounds = np.concatenate([[0], np.cumsum(gen_frames)]) * up
        for j, i in enumerate(with_codes):
            per_row[i] = i16[bounds[j]: bounds[j + 1]]
        outs = [(sr, np.concatenate([per_row[i] for i in range(len(rows))
                                     if line_of[i] == k])[:, None])
                for k in range(len(texts))]
        sp.set(rows=len(rows) * int(gen["num_beams"]),
               decode_steps=times.decode_steps, s2m_rows=2 * len(durs),
               s2m_frames=2 * len(durs) * max(durs, default=0),
               real_frames=2 * sum(durs), nfe=times.nfe,
               graph_captures=self._beam_workspaces.captures - n0)
        times.total = time.perf_counter() - start
        times.audio_seconds = i16.size / sr
        self.last_times, self.last_mel, self.last_noise = times, mel, noise
        self.last_codes, self.last_frames = served, durs
        self.last_prompt_frames, self.last_rows = tp, line_of
        if verbose:
            print(f">> IndexTTS-2: {len(texts)} lines, {len(rows)} rows, "
                  f"{times.decode_steps} decode steps, {times.nfe} guided "
                  f"forwards; gpt {times.gpt_gen:.2f} s, s2m "
                  f"{times.s2m:.2f} s, vocoder {times.bigvgan:.2f} s, RTF "
                  f"{times.rtf:.4f}")
        return outs
