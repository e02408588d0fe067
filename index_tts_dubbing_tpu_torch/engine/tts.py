"""IndexTTS engine: zero-shot TTS with the reference's public API.

Counterpart of the JAX package's ``engine/tts.py`` for what the port
covers so far: ``infer_fast`` on the fused route's "fused+stream" flavour
(decode → trim → latent pass on the device, then the windowed C-major
vocoder on kernels K1 and K2). The decode is the reference's default,
beam sampling with ``num_beams=3``, or beam search (``do_sample=False``),
or with ``num_beams=1`` sampling or greedy; the report names the one that
ran. Requests outside the port raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.config import EngineConfig, load_config
from index_tts_dubbing_tpu_torch.engine import decode as decode_mod
from index_tts_dubbing_tpu_torch.engine import fused as fused_mod
from index_tts_dubbing_tpu_torch.engine.decode import SamplingConfig
from index_tts_dubbing_tpu_torch.engine.vocoder import WindowedVocoder
from index_tts_dubbing_tpu_torch.models import gpt as gpt_model
from index_tts_dubbing_tpu_torch.ops.mel import MelSpectrogram
from index_tts_dubbing_tpu_torch.utils import audio as audio_util
from index_tts_dubbing_tpu_torch.utils.front import (TextNormalizer,
                                                     TextTokenizer)


def remove_long_silence(codes: np.ndarray, stop_mel_token: int = 8193,
                        silent_token: int = 52, max_consecutive: int = 30
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Trim at the stop token and cap runs of the silence code at 10 (host)."""
    out_rows: List[np.ndarray] = []
    lens: List[int] = []
    for row in np.asarray(codes):
        stops = np.nonzero(row == stop_mel_token)[0]
        ln = int(stops[0]) if stops.size else row.size
        if int(np.sum(row == silent_token)) > max_consecutive:
            kept = []
            run = 0
            for k in range(ln):
                if row[k] != silent_token:
                    kept.append(k)
                    run = 0
                elif run < 10:
                    kept.append(k)
                    run += 1
            row = row[kept]
            ln = len(kept)
        else:
            row = row[:ln]
        out_rows.append(row)
        lens.append(ln)
    max_len = max(lens) if lens else 0
    padded = np.full((len(out_rows), max_len), stop_mel_token, codes.dtype)
    for i, r in enumerate(out_rows):
        padded[i, : r.size] = r
    return padded, np.asarray(lens, np.int64)


def remove_long_silence_device(codes: torch.Tensor, stop_mel_token: int = 8193,
                               silent_token: int = 52,
                               max_consecutive: int = 30
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``remove_long_silence`` on the device at static shape: codes (B, S) →
    (compacted codes stop-padded (B, S), lens (B,))."""
    b, s = codes.shape
    idx = torch.arange(s, device=codes.device)[None, :]
    is_stop = codes == stop_mel_token
    first = torch.argmax(is_stop.int(), dim=1)
    ln = torch.where(is_stop.any(dim=1), first, torch.full_like(first, s))[:, None]
    silent = codes == silent_token
    # run length of consecutive silents ending at i: i − last non-silent index
    last_ns = torch.cummax(torch.where(~silent, idx, -1), dim=1).values
    run = idx - last_ns
    trim_row = silent.sum(dim=1, keepdim=True) > max_consecutive
    keep = (idx < ln) & torch.where(trim_row, ~silent | (run <= 10), True)
    lens = keep.sum(dim=1)
    # dropped tokens all write stop to column s-1; a kept token lands there
    # only when nothing was dropped, so the writes never conflict
    dst = torch.where(keep, keep.cumsum(dim=1) - 1, s - 1)
    out = torch.full_like(codes, stop_mel_token)
    out.scatter_(1, dst, torch.where(keep, codes, stop_mel_token))
    return out, lens


class CharTokenizer:
    """Fallback tokenizer when no bpe.model ships with the checkpoints:
    deterministic codepoint hashing into the text-token space."""

    punctuation_marks_tokens = [".", "!", "?", "…"]

    def __init__(self, vocab_size: int = 12000,
                 normalizer: Optional[TextNormalizer] = None):
        self.vocab_size = vocab_size
        self.normalizer = normalizer
        if normalizer:
            normalizer.load()

    def tokenize(self, text: str) -> List[str]:
        if self.normalizer:
            text = self.normalizer.normalize(text)
        return [c for c in text if not c.isspace()]

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        if isinstance(tokens, str):
            tokens = [tokens]
        return [2 + (ord(t[0]) % (self.vocab_size - 3)) for t in tokens]

    def split_sentences(self, tokens: List[str],
                        max_tokens_per_sentence: int = 120) -> List[List[str]]:
        return TextTokenizer.split_sentences_by_token(
            tokens, self.punctuation_marks_tokens, max_tokens_per_sentence)


@dataclass
class StageTimes:
    gpt_gen: float = 0.0        # decode + trim + latent pass (device synced)
    bigvgan: float = 0.0        # windowed vocoder
    total: float = 0.0
    audio_seconds: float = 0.0
    decode: str = ""            # which decode ran
    decode_steps: int = 0       # its steps

    @property
    def rtf(self) -> float:
        return self.total / max(self.audio_seconds, 1e-9)


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


class IndexTTS:
    """The engine, with the reference's public constructor and
    ``infer_fast``. Runs on ``device`` ("cuda" unless the caller says)."""

    TEXT_BUCKETS = (16, 32, 48, 64, 80, 96, 120)
    FUSED_BATCH_BUCKETS = (1, 2, 4, 8, 16, 24, 32)
    # at or below this decode cap the JAX engine vocodes inside its one
    # program (the "fused" flavour), which this slice does not cover
    FUSED_FULL_VOCODE_MAX_STEPS = 256

    def __init__(self, cfg_path: Optional[str] = None,
                 model_dir: Optional[str] = None, is_fp16: bool = False,
                 device=None, use_cuda_kernel=None,
                 config: Optional[EngineConfig] = None,
                 params: Optional[Dict[str, Any]] = None,
                 use_pallas: bool = False, seed: int = 0,
                 verbose_init: bool = True,
                 quantize: Optional[str] = None,
                 mesh=None, vocoder_window: Optional[int] = None):
        if use_pallas:
            raise _later("the channels-last snake kernel (use_pallas)",
                         "queue B, item 3")
        if quantize is not None:
            raise _later("int8 weight quantisation", "queue A, item 14")
        if mesh is not None:
            raise _later("mesh-parallel decode", "queue A, item 14")
        self.device = torch.device(device if device is not None else "cuda")
        self.cfg = (config if config is not None
                    else load_config(cfg_path) if cfg_path else EngineConfig())
        self.gpt_cfg = self.cfg.gpt
        self.bigvgan_cfg = self.cfg.bigvgan
        self.dtype = torch.bfloat16 if is_fp16 else torch.float32
        self.stop_mel_token = self.gpt_cfg.stop_mel_token
        self.model_dir = Path(model_dir) if model_dir else None
        self.model_version = self.cfg.version
        self._log = print if verbose_init else (lambda *a, **k: None)
        if params is None:
            if self.model_dir is not None and any(
                    (self.model_dir / f).exists()
                    for f in ("gpt.npz", self.cfg.gpt_checkpoint)):
                raise _later("checkpoint loading", "queue A, item 14")
            gen = torch.Generator(self.device).manual_seed(seed)
            params = weights.init(self.cfg, gen, self.device)
        self.params = weights.cast_floating(
            {k: _to_device(v, self.device) for k, v in params.items()},
            self.dtype)
        self.normalizer = TextNormalizer()
        self.normalizer.load()
        self.tokenizer = self._load_tokenizer()
        m = self.cfg.mel
        self.mel_fn = MelSpectrogram(
            sample_rate=m.sample_rate, n_fft=m.n_fft, hop_length=m.hop_length,
            win_length=m.win_length, n_mels=m.n_mels, device=self.device)
        self.vocoder = WindowedVocoder(self.params["bigvgan"], self.bigvgan_cfg,
                                       compute_dtype=self.dtype,
                                       **({"window": vocoder_window}
                                          if vocoder_window else {}))
        self.cache_audio_prompt = None
        self.cache_cond_mel = None
        self._generator = torch.Generator(self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    def _load_tokenizer(self):
        if self.model_dir is not None:
            bpe = self.model_dir / self.cfg.bpe_model
            if bpe.exists():
                return TextTokenizer(str(bpe), self.normalizer)
        return CharTokenizer(self.gpt_cfg.number_text_tokens, self.normalizer)

    def _cond_mel(self, audio_prompt) -> torch.Tensor:
        if (self.cache_cond_mel is None
                or self.cache_audio_prompt != audio_prompt):
            wav = audio_util.load_audio_mean_mono(audio_prompt,
                                                  self.cfg.mel.sample_rate)
            self.cache_cond_mel = self.mel_fn(wav)          # (1, n_mels, T)
            self.cache_audio_prompt = audio_prompt
        return self.cache_cond_mel

    def _conditioning(self, cond_mel: torch.Tensor) -> torch.Tensor:
        lens = torch.tensor([cond_mel.shape[-1]], device=self.device)
        return gpt_model.get_conditioning(self.params["gpt"], self.gpt_cfg,
                                          cond_mel.transpose(1, 2), lens)

    def _sampling_config(self, kw: Dict[str, Any]) -> SamplingConfig:
        # reference defaults: num_beams=3 with do_sample=True is beam
        # sampling, with do_sample=False beam search; num_beams=1 is plain
        # sampling or greedy
        self._num_beams = kw.pop("num_beams", 3)
        self._length_penalty = kw.pop("length_penalty", 0.0)
        return SamplingConfig(
            do_sample=kw.pop("do_sample", True),
            top_p=kw.pop("top_p", 0.8),
            top_k=kw.pop("top_k", 30),
            temperature=kw.pop("temperature", 1.0),
            repetition_penalty=kw.pop("repetition_penalty", 10.0),
            # clamped to the model's positional budget
            max_mel_tokens=min(kw.pop("max_mel_tokens", 600),
                               self.gpt_cfg.max_mel_tokens),
            typical_sampling=kw.pop("typical_sampling", False),
            typical_mass=kw.pop("typical_mass", 0.9),
        )

    def _fused_eligible(self, rows: List[np.ndarray]) -> bool:
        """Non-empty rows, batch within the largest batch bucket, every row
        within the largest text bucket."""
        if not rows or len(rows) > self.FUSED_BATCH_BUCKETS[-1]:
            return False
        limit = min(self.TEXT_BUCKETS[-1], self.gpt_cfg.max_text_tokens)
        return not any(r.size == 0 or r.size > limit for r in rows)

    def sentence_rows(self, text: str, max_text_tokens_per_sentence: int = 100
                      ) -> List[np.ndarray]:
        """Text → one int32 token-id row per sentence, as infer_fast splits it."""
        sentences = self.tokenizer.split_sentences(
            self.tokenizer.tokenize(text), max_text_tokens_per_sentence)
        return [np.asarray(self.tokenizer.convert_tokens_to_ids(s), np.int32)
                for s in sentences]

    def fused_batch(self, rows: List[np.ndarray]) -> Dict[str, torch.Tensor]:
        """The fused route's device inputs for sentence rows: the batch padded
        to a FUSED_BATCH_BUCKET with dead rows (``live`` False: done at
        decode step 0, zero stream frames) and the text to a TEXT_BUCKET.
        Returns the prefix arrays (ids, pos, seg, cond_idx), the unframed
        text rows and their lengths, and ``live``."""
        n_real = len(rows)
        n_pad = next(bb for bb in self.FUSED_BATCH_BUCKETS if bb >= n_real)
        rows = list(rows) + [np.array([2], np.int32)] * (n_pad - n_real)
        lmax = max(r.size for r in rows)
        pad_to = next((bb for bb in self.TEXT_BUCKETS if bb >= lmax), lmax)
        pre = decode_mod.prepare_prefix_host(self.gpt_cfg, rows, pad_to=pad_to)
        text = np.full((n_pad, pad_to), self.gpt_cfg.stop_text_token, np.int64)
        tlens = np.zeros(n_pad, np.int64)
        for i, r in enumerate(rows):
            text[i, : r.size] = r
            tlens[i] = r.size
        dev = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=self.device)
        out = {k: dev(pre[k]) for k in ("ids", "pos", "seg", "cond_idx")}
        out.update(text=dev(text), text_lens=dev(tlens),
                   live=torch.as_tensor(np.arange(n_pad) < n_real,
                                        device=self.device))
        return out

    def _decode_name(self, sc: SamplingConfig) -> str:
        if self._num_beams > 1:
            kind = "beam sampling" if sc.do_sample else "beam search"
            return f"{kind} (num_beams={self._num_beams}, reorder=anc)"
        return "sampling" if sc.do_sample else "greedy"

    def _synthesize_fused_public(self, conds: torch.Tensor,
                                 rows: List[np.ndarray], sc: SamplingConfig,
                                 spk: torch.Tensor, times: StageTimes
                                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Run decode → trim → latent on the device for the padded batch of
        ``fused_batch``, then vocode the real rows' stream. Returns
        (float32 wav, per-row latent frames of the real rows)."""
        n_real = len(rows)
        x = self.fused_batch(rows)
        t0 = time.perf_counter()
        res = fused_mod.synthesize_fused_lat(
            self.params["gpt"], self.gpt_cfg, sc, conds, x["ids"], x["pos"],
            x["seg"], x["cond_idx"], x["text"], x["text_lens"],
            self._generator, x["live"], num_beams=self._num_beams,
            length_penalty=self._length_penalty)
        lens_all = res.lens.cpu().numpy()            # the one host sync
        times.gpt_gen += time.perf_counter() - t0
        times.decode = self._decode_name(sc)
        times.decode_steps = res.steps
        self.last_fused_res = res
        self.last_fused_flavor = "fused+stream"
        t0 = time.perf_counter()
        wav = self.vocoder.stream_device(res.lat, lens_all,
                                         order=np.arange(n_real), spk=spk)
        times.bigvgan += time.perf_counter() - t0
        self.last_wav = wav
        return wav, lens_all[:n_real]

    def _check_covered(self, sc: SamplingConfig) -> None:
        if sc.max_mel_tokens <= self.FUSED_FULL_VOCODE_MAX_STEPS:
            raise _later("the one-program 'fused' flavour (max_mel_tokens <= "
                         f"{self.FUSED_FULL_VOCODE_MAX_STEPS})",
                         "queue A, item 12")

    def infer_fast(self, audio_prompt, text, output_path=None, verbose=False,
                   max_text_tokens_per_sentence=100,
                   sentences_bucket_max_size=4, **generation_kwargs):
        """Bucketed batched synthesis (reference infer_fast); returns
        (sample_rate, int16 (T, 1)) or writes ``output_path``."""
        start_time = time.perf_counter()
        times = StageTimes()
        sc = self._sampling_config(generation_kwargs)
        self._check_covered(sc)
        cond_mel = self._cond_mel(audio_prompt)
        conds = self._conditioning(cond_mel)
        sent_rows = self.sentence_rows(text, max_text_tokens_per_sentence)
        sr = self.cfg.mel.sample_rate
        spk = self.vocoder.speaker_embedding(cond_mel.transpose(1, 2))
        if not self._fused_eligible(sent_rows):
            raise _later("the staged infer_fast route", "queue A, item 12")
        if verbose:
            print(f">> {sum(r.size for r in sent_rows)} tokens, "
                  f"{len(sent_rows)} sentences")
        wav, _ = self._synthesize_fused_public(conds, sent_rows, sc, spk, times)
        wav = np.clip(wav * 32767.0, -32767.0, 32767.0)
        times.total = time.perf_counter() - start_time
        times.audio_seconds = wav.size / sr
        self._report(times)
        return self._emit(wav, sr, output_path)

    def infer(self, *args, **kwargs):
        raise _later("sequential infer", "queue A, item 12")

    def infer_batch(self, *args, **kwargs):
        raise _later("infer_batch", "queue A, item 12")

    def _report(self, times: StageTimes) -> None:
        print(">> [fast] synthesis path: fused (decode+trim+latent on the "
              "device + streamed vocode)")
        print(f">> [fast] decode: {times.decode}, {times.decode_steps} steps")
        print(f">> [fast] gpt_gen_time: {times.gpt_gen:.2f} s")
        print(f">> [fast] bigvgan_time: {times.bigvgan:.2f} s")
        print(f">> [fast] Total inference time: {times.total:.2f} s")
        print(f">> [fast] Generated audio length: {times.audio_seconds:.2f} s")
        print(f">> [fast] RTF: {times.rtf:.4f}")
        self.last_times = times

    def _emit(self, wav: np.ndarray, sr: int, output_path):
        wav_i16 = wav.astype(np.int16)
        if output_path:
            audio_util.write_wav(output_path, wav_i16, sr)
            return output_path
        return sr, wav_i16[None, :].T


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
