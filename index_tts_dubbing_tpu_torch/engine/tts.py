"""IndexTTS engine: zero-shot TTS with the reference's public API.

Counterpart of the JAX package's ``engine/tts.py``:

- ``infer``: one decode per sentence, then one latent pass and one streamed
  vocode over the collected rows;
- ``infer_fast``: the fused route when ``_fused_eligible`` accepts the
  sentences (decode → trim → latent pass on the device, then, for a decode
  cap above 256, the streamed vocoder, or at most 256 the static window plan
  of the one-program flavour, which emits int16 on the device), else the
  staged route (bucketed decodes, host trim, latent pass, streamed vocode);
- ``infer_batch``: many texts at once, on either route, cut back per text;
  with ``continuous=True`` every sentence goes through continuous-batching
  slots (engine/continuous.py) on the staged route.

Every route vocodes through the windowed C-major vocoder on kernels K1 and
K2. The decode is the reference's default, beam sampling with
``num_beams=3``, or beam search (``do_sample=False``), or with
``num_beams=1`` sampling or greedy; the report names the one that ran.
Requests outside the port raise ``NotImplementedError`` naming the ROADMAP
item that brings them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.config import EngineConfig, load_config
from index_tts_dubbing_tpu_torch.engine import continuous as cb
from index_tts_dubbing_tpu_torch.engine import decode as decode_mod
from index_tts_dubbing_tpu_torch.engine import fused as fused_mod
from index_tts_dubbing_tpu_torch.engine.decode import SamplingConfig
from index_tts_dubbing_tpu_torch.engine.vocoder import WindowedVocoder
from index_tts_dubbing_tpu_torch.models import gpt as gpt_model
from index_tts_dubbing_tpu_torch.ops.mel import MelSpectrogram
from index_tts_dubbing_tpu_torch.utils import audio as audio_util
from index_tts_dubbing_tpu_torch.utils import convert
from index_tts_dubbing_tpu_torch.utils.checkpoint import (flatten_tree,
                                                          load_params)
from index_tts_dubbing_tpu_torch.utils.front import (TextNormalizer,
                                                     TextTokenizer)
from index_tts_dubbing_tpu_torch.utils.quant import quantize_gpt_int8


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


def pad_tokens_cat(rows: List[np.ndarray], stop_text_token: int,
                   start_text_token: int, version: Optional[float] = 1.5
                   ) -> np.ndarray:
    """Batch text rows by the reference's version-keyed padding: v1.5+
    right-pads with stop_text_token; v1.0 pads with up to 8
    stop_text_tokens, then start_text_tokens. The engine does not need it:
    the prefix builder strips every start/stop token before framing, so both
    styles give the same prefix; it is kept for callers that want the
    reference's batched-token layout."""
    max_len = max(r.size for r in rows)
    out = np.empty((len(rows), max_len), np.int32)
    for i, r in enumerate(rows):
        r = np.asarray(r).reshape(-1)
        pad = max_len - r.size
        if version is not None and version >= 1.5:
            row = np.concatenate(
                [r, np.full(pad, stop_text_token, np.int32)])
        else:
            n = min(8, pad)
            row = np.concatenate(
                [r, np.full(n, stop_text_token, np.int32),
                 np.full(pad - n, start_text_token, np.int32)])
        out[i] = row[:max_len]
    return out


def bucket_sentences(sentences: Sequence, bucket_max_size: int = 4
                     ) -> List[List[Dict]]:
    """Length-sorted sentence bucketing (the reference's infer_fast)."""
    outputs = [{"idx": i, "sent": s, "len": len(s)}
               for i, s in enumerate(sentences)]
    if len(outputs) <= bucket_max_size:
        return [outputs]
    buckets: List[List[Dict]] = []
    factor = 1.5
    last_bucket = None
    last_median = 0
    for sent in sorted(outputs, key=lambda x: x["len"]):
        if sent["len"] == 0:
            continue
        if (last_bucket is None or sent["len"] >= int(last_median * factor)
                or len(last_bucket) >= bucket_max_size):
            buckets.append([sent])
            last_bucket = buckets[-1]
            last_median = sent["len"]
        else:
            last_bucket.append(sent)
            last_median = last_bucket[len(last_bucket) // 2]["len"]
    out_buckets: List[List[Dict]] = []
    only_ones: List[Dict] = []
    for b in buckets:
        (only_ones if len(b) == 1 else out_buckets).append(
            b[0] if len(b) == 1 else b)
    if only_ones:
        for b in out_buckets:
            if len(b) < bucket_max_size:
                b.append(only_ones.pop(0))
                if not only_ones:
                    break
        if only_ones:
            out_buckets.extend(
                only_ones[i:i + bucket_max_size]
                for i in range(0, len(only_ones), bucket_max_size))
    return out_buckets


def load_npz_params(path) -> Dict[str, Any]:
    """``utils.checkpoint.load_params``, refusing a leaf whose dtype numpy
    cannot read as numbers: a bfloat16 array saved by numpy with
    ``ml_dtypes`` reads back as raw two-byte voids (``|V2``), which would
    otherwise load as garbage."""
    tree = load_params(path)
    for key, leaf in flatten_tree(tree).items():
        if leaf.dtype.kind not in "biuf":
            raise ValueError(f"{path}: leaf {key!r} has dtype {leaf.dtype}, "
                             "which numpy cannot read as numbers; save the "
                             "checkpoint in float32")
    return tree


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _to_i16(wav: np.ndarray) -> np.ndarray:
    """The output scaling: clip(wav·32767) truncated to int16."""
    return np.clip(wav * 32767.0, -32767.0, 32767.0).astype(np.int16)


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
    gpt_gen: float = 0.0        # decode (+ trim + latent pass on the fused route)
    gpt_forward: float = 0.0    # latent pass (staged route: dispatch only)
    bigvgan: float = 0.0        # vocoder
    total: float = 0.0
    audio_seconds: float = 0.0
    decode: str = ""            # which decode ran
    decode_steps: int = 0       # its steps, summed over sequential decodes

    @property
    def rtf(self) -> float:
        return self.total / max(self.audio_seconds, 1e-9)


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


class IndexTTS:
    """The engine, with the reference's public constructor, ``infer``,
    ``infer_fast`` and ``infer_batch``. Runs on ``device`` ("cuda" unless
    the caller says).

    ``params``: the port's tree of tensors, or the JAX package's tree as its
    ``init`` or ``load_params`` gives it (numpy or ``ml_dtypes`` leaves, the
    GPT trunk stacked or not); either is moved to ``device`` and cast to the
    engine's dtype. Without it the weights come from ``model_dir``
    (``gpt.npz`` + ``bigvgan.npz``, else the reference's ``.pth`` pair),
    else from ``seed`` (``_load_params``).

    ``use_pallas`` sets ``BigVGANConfig.use_pallas``, as the JAX engine does:
    the channels-last BigVGAN (models/bigvgan.py) and every
    ``WindowedVocoder(layout="ref")`` built on ``bigvgan_cfg`` then run their
    activations on kernel B3. It does not change the engine's own vocoder,
    the C-major one on kernels K1 and K2, whatever the flag, exactly as the
    JAX engine's on its accelerator.

    ``quantize="int8"``: the GPT trunk's matmuls and the mel head as
    weight-only int8 (utils/quant.py), quantised from the weights in the
    engine's dtype; any other mode raises ``ValueError``. A config with
    ``condition_type == "perceiver"`` conditions through the v1.0 encoder
    (models/legacy_cond.py).

    After each request: ``last_path`` ("fused" or "staged"), ``last_times``
    (StageTimes), ``last_sentence_frames`` (latent frames per sentence, in
    stream order) and ``last_wav`` (the float32 wav behind the int16 output;
    None on the one-program flavour, whose float wav stays on the device in
    ``last_fused_res.wav``); on the fused route also ``last_fused_res`` and
    ``last_fused_flavor`` ("fused" or "fused+stream"); after
    ``infer_batch(continuous=True)`` also ``last_cb_stats`` (steps, installs,
    refills, occupancy).
    """

    TEXT_BUCKETS = (16, 32, 48, 64, 80, 96, 120)
    CODE_BUCKETS = (64, 128, 192, 256, 384, 512, 608)
    FUSED_BATCH_BUCKETS = (1, 2, 4, 8, 16, 24, 32)
    # above this decode cap the fused route vocodes through the window-exact
    # stream; at or below it through the static window plan of the
    # one-program flavour, sized by the cap
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
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode: {quantize!r}")
        if mesh is not None:
            raise _later("mesh-parallel decode", "queue A, item 14")
        self.device = torch.device(device if device is not None else "cuda")
        self.cfg = (config if config is not None
                    else load_config(cfg_path) if cfg_path else EngineConfig())
        if use_pallas:
            self.cfg = replace(self.cfg, bigvgan=replace(self.cfg.bigvgan,
                                                         use_pallas=True))
        self.gpt_cfg = self.cfg.gpt
        self.bigvgan_cfg = self.cfg.bigvgan
        self.dtype = torch.bfloat16 if is_fp16 else torch.float32
        self.stop_mel_token = self.gpt_cfg.stop_mel_token
        self.model_dir = Path(model_dir) if model_dir else None
        self.model_version = self.cfg.version
        self._log = print if verbose_init else (lambda *a, **k: None)
        if params is None:
            params = self._load_params(seed)
        self.params = weights.from_jax_params(params, self.device, self.dtype)
        if quantize == "int8":
            # weight-only int8 GPT trunk (utils/quant.py), quantised from the
            # weights in the engine's dtype as JAX does; the scales stay
            # float32, and the conditioning encoder and the embeddings stay
            # in the engine's dtype
            self.params["gpt"] = quantize_gpt_int8(self.params["gpt"])
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
        self.gr_progress = None
        # the decode of the last request (set by _sampling_config)
        self._num_beams, self._length_penalty = 1, 0.0
        self._generator = torch.Generator(self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    def _load_params(self, seed: int) -> Dict[str, Any]:
        """The model directory's checkpoints: ``gpt.npz`` + ``bigvgan.npz``
        (``utils.checkpoint.save_params``) first, else the reference's
        ``.pth`` pair named by the config, converted; with neither, random
        weights from ``seed`` on the engine's device."""
        if self.model_dir is not None:
            npz_gpt = self.model_dir / "gpt.npz"
            npz_bv = self.model_dir / "bigvgan.npz"
            if npz_gpt.exists() and npz_bv.exists():
                return {"gpt": load_npz_params(npz_gpt),
                        "bigvgan": load_npz_params(npz_bv)}
            pth_gpt = self.model_dir / self.cfg.gpt_checkpoint
            pth_bv = self.model_dir / self.cfg.bigvgan_checkpoint
            if pth_gpt.exists() and pth_bv.exists():
                return {
                    "gpt": convert.convert_unified_voice(
                        convert.load_torch_state_dict(str(pth_gpt)),
                        layers=self.gpt_cfg.layers,
                        cond_blocks=self.gpt_cfg.cond_num_blocks),
                    "bigvgan": convert.convert_bigvgan(
                        convert.load_torch_state_dict(str(pth_bv)),
                        num_upsamples=self.bigvgan_cfg.num_upsamples,
                        num_kernels=self.bigvgan_cfg.num_kernels),
                }
        gen = torch.Generator(self.device).manual_seed(seed)
        return weights.init(self.cfg, gen, self.device)

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

    def set_cond_mel(self, mel, key: str = "<direct>") -> None:
        """Inject a conditioning mel directly ((1, n_mels, T)); requests whose
        audio prompt is ``key`` then use it."""
        self.cache_audio_prompt = key
        self.cache_cond_mel = torch.as_tensor(np.asarray(mel, np.float32),
                                              device=self.device)

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

    def _ids(self, sentence: List[str]) -> np.ndarray:
        return np.asarray(self.tokenizer.convert_tokens_to_ids(sentence),
                          np.int32)

    def sentence_rows(self, text: str, max_text_tokens_per_sentence: int = 100
                      ) -> List[np.ndarray]:
        """Text → one int32 token-id row per sentence, as infer_fast splits it."""
        sentences = self.tokenizer.split_sentences(
            self.tokenizer.tokenize(text), max_text_tokens_per_sentence)
        return [self._ids(s) for s in sentences]

    # -- decode and latent pass ----------------------------------------
    def _decode_name(self, sc: SamplingConfig) -> str:
        if self._num_beams > 1:
            kind = "beam sampling" if sc.do_sample else "beam search"
            return f"{kind} (num_beams={self._num_beams}, reorder=anc)"
        return "sampling" if sc.do_sample else "greedy"

    def _decode_batch(self, conds: torch.Tensor, token_rows: List[np.ndarray],
                      sc: SamplingConfig) -> Tuple[np.ndarray, np.ndarray]:
        """AR decode of a batch of token rows at a bucketed text width:
        (codes (n, steps), lengths (n,)) on the host."""
        res, n_real = self._decode_batch_async(conds, token_rows, sc)
        return (res.codes[:n_real].cpu().numpy(),
                res.lengths[:n_real].cpu().numpy())

    def _decode_batch_async(self, conds: torch.Tensor,
                            token_rows: List[np.ndarray], sc: SamplingConfig
                            ) -> Tuple[decode_mod.GenerateResult, int]:
        """Run one bucketed decode and leave its result on the device:
        (GenerateResult, real row count). The caller reads the codes back
        when it needs them."""
        lmax = max(r.size for r in token_rows)
        pad_to = next((b for b in self.TEXT_BUCKETS if b >= lmax), lmax)
        pre = decode_mod.prepare_prefix_host(self.gpt_cfg, token_rows,
                                             pad_to=pad_to)
        dev = lambda k: torch.as_tensor(pre[k].astype(np.int64),
                                        device=self.device)
        emb, keep = decode_mod.build_prefix_emb(
            self.params["gpt"], self.gpt_cfg, conds, dev("ids"), dev("pos"),
            dev("seg"), dev("cond_idx"))
        args = (self.params["gpt"], self.gpt_cfg, sc, emb, keep)
        beam = dict(num_beams=self._num_beams,
                    length_penalty=self._length_penalty)
        if self._num_beams > 1 and sc.do_sample:
            res = decode_mod.generate_beam_sample(*args, self._generator,
                                                  **beam)
        elif self._num_beams > 1:
            res = decode_mod.generate_beam(*args, **beam)
        else:
            res = decode_mod.generate(*args, self._generator)
        return res, len(token_rows)

    def _decode_continuous(self, conds: torch.Tensor,
                           token_rows: List[np.ndarray], sc: SamplingConfig,
                           batch: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        """Continuous-batching decode over many rows (engine/continuous.py):
        a slot is refilled the moment its row finishes. Sampling or greedy
        per row, whatever num_beams says, as in the JAX engine. Returns
        (codes (n, max_len), lengths (n,)) on the host; the batcher's
        ``stats`` stay in ``last_cb_stats``."""
        batcher = cb.ContinuousBatcher(
            self.params["gpt"], self.gpt_cfg, sc, conds,
            batch=min(batch, len(token_rows)),
            text_buckets=self.TEXT_BUCKETS, generator=self._generator)
        results = batcher.run(
            [cb.CBRequest(uid=i, text_ids=r) for i, r in enumerate(token_rows)],
            dtype=self.dtype)
        self.last_cb_stats = dict(batcher.stats, slots=batcher.batch)
        max_len = max((ln for _, ln in results.values()), default=0)
        codes = np.full((len(token_rows), max(max_len, 1)),
                        self.stop_mel_token, np.int64)
        lens = np.zeros(len(token_rows), np.int64)
        for i in range(len(token_rows)):
            row, ln = results[i]
            codes[i, :ln] = row[:ln]
            lens[i] = ln
        return codes, lens

    def _bucket_dims(self, lt: int, code_len: int) -> Tuple[int, int]:
        lb = next((b for b in self.TEXT_BUCKETS if b >= lt), lt)
        lb = max(min(lb, self.gpt_cfg.max_text_tokens), lt)
        mb = next((b for b in self.CODE_BUCKETS if b >= code_len), code_len)
        mb = max(min(mb, self.gpt_cfg.max_mel_tokens), code_len)
        return lb, mb

    def _latents(self, conds: torch.Tensor, text_tokens: np.ndarray,
                 codes: np.ndarray, code_len: int) -> np.ndarray:
        """Latent pass for one row: (code_len, C) on the host."""
        return self._latents_batch(conds, [(text_tokens, codes, code_len)])[0]

    def _latents_batch(self, conds: torch.Tensor, rows) -> List[np.ndarray]:
        """Latent passes for many (text_tokens, codes, code_len) rows, one
        batched pass per bucket shape; (code_len, C) per row on the host."""
        lat, lens, inv = self._latents_batch_device(conds, rows,
                                                    bucket_rows=False)
        latnp = lat.float().cpu().numpy()
        return [latnp[inv[i], : int(lens[inv[i]])] for i in range(len(rows))]

    def _latents_batch_device(self, conds: torch.Tensor, rows,
                              bucket_rows: bool = True
                              ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """Latent passes whose outputs stay on the device: (lat (R, MB, C),
        lens (n,), inv (n,)), input row i in lat row inv[i], every group
        padded to the largest code bucket MB. With ``bucket_rows`` R is n
        rounded up to a power of two (the pad rows are junk, never read)."""
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, (text_tokens, _, code_len) in enumerate(rows):
            lb, mb = self._bucket_dims(text_tokens.size, code_len)
            groups.setdefault((lb, mb), []).append(i)
        mb_all = max(mb for (_, mb) in groups)
        dev = lambda a: torch.as_tensor(a, device=self.device)
        parts, rowmap, lens = [], [], []
        for (lb, mb), idxs in groups.items():
            g = len(idxs)
            text = np.full((g, lb), self.gpt_cfg.stop_text_token, np.int64)
            cpad = np.full((g, mb), self.stop_mel_token, np.int64)
            tlens = np.zeros(g, np.int64)
            clens = np.zeros(g, np.int64)
            for gi, i in enumerate(idxs):
                text_tokens, codes, code_len = rows[i]
                text[gi, :text_tokens.size] = text_tokens
                cpad[gi, :code_len] = codes[:code_len]
                tlens[gi] = text_tokens.size
                clens[gi] = code_len
            cnds = conds
            if cnds.shape[0] == 1 and g > 1:
                cnds = cnds.expand((g,) + cnds.shape[1:])
            lat = gpt_model.forward_latent_bucketed(
                self.params["gpt"], self.gpt_cfg, cnds, dev(text), dev(tlens),
                dev(cpad), dev(clens))
            parts.append(F.pad(lat, (0, 0, 0, mb_all - mb)))
            rowmap.append(idxs)
            lens.append(clens)
        lat = torch.cat(parts) if len(parts) > 1 else parts[0]
        n = len(rows)
        if bucket_rows and n > 1:
            rb = 1 << (n - 1).bit_length()
            lat = F.pad(lat, (0, 0, 0, 0, 0, rb - n))
        inv = np.empty(n, np.int64)
        inv[np.concatenate(rowmap)] = np.arange(n)
        return lat, np.concatenate(lens), inv

    def _latent_rows(self, codes: np.ndarray, rows: List[np.ndarray]
                     ) -> List[Tuple[np.ndarray, np.ndarray, int]]:
        """Host silence trim of each decoded row: (text ids, codes, frames)."""
        out = []
        for i, ids in enumerate(rows):
            row_codes, row_lens = remove_long_silence(codes[i:i + 1],
                                                      self.stop_mel_token)
            out.append((ids, row_codes[0], int(row_lens[0])))
        return out

    # -- the fused route -------------------------------------------------
    def _fused_eligible(self, rows: List[np.ndarray]) -> bool:
        """Non-empty rows, batch within the largest batch bucket, every row
        within the largest text bucket."""
        if not rows or len(rows) > self.FUSED_BATCH_BUCKETS[-1]:
            return False
        limit = min(self.TEXT_BUCKETS[-1], self.gpt_cfg.max_text_tokens)
        return not any(r.size == 0 or r.size > limit for r in rows)

    def _text_batch(self, rows: List[np.ndarray]) -> Dict[str, torch.Tensor]:
        """Rows padded to one TEXT_BUCKET: the prefix arrays (ids, pos, seg,
        cond_idx) and the unframed text rows with their lengths."""
        lmax = max(r.size for r in rows)
        pad_to = next((bb for bb in self.TEXT_BUCKETS if bb >= lmax), lmax)
        pre = decode_mod.prepare_prefix_host(self.gpt_cfg, rows, pad_to=pad_to)
        text = np.full((len(rows), pad_to), self.gpt_cfg.stop_text_token,
                       np.int64)
        tlens = np.zeros(len(rows), np.int64)
        for i, r in enumerate(rows):
            text[i, : r.size] = r
            tlens[i] = r.size
        dev = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                        device=self.device)
        out = {k: dev(pre[k]) for k in ("ids", "pos", "seg", "cond_idx")}
        out.update(text=dev(text), text_lens=dev(tlens))
        return out

    def _pad_batch(self, rows: List[np.ndarray]
                   ) -> Tuple[List[np.ndarray], torch.Tensor]:
        """Rows padded to a FUSED_BATCH_BUCKET with dead one-token rows, and
        the ``live`` mask (dead rows stop at decode step 0: zero frames)."""
        n_real = len(rows)
        n_pad = next(bb for bb in self.FUSED_BATCH_BUCKETS if bb >= n_real)
        rows = list(rows) + [np.array([2], np.int32)] * (n_pad - n_real)
        live = torch.as_tensor(np.arange(n_pad) < n_real, device=self.device)
        return rows, live

    def fused_batch(self, rows: List[np.ndarray]) -> Dict[str, torch.Tensor]:
        """The fused route's device inputs for sentence rows: ``_text_batch``
        of the rows padded to a FUSED_BATCH_BUCKET, and ``live``."""
        rows, live = self._pad_batch(rows)
        return dict(self._text_batch(rows), live=live)

    def _fused_lat(self, conds: torch.Tensor, rows: List[np.ndarray],
                   sc: SamplingConfig, live: Optional[torch.Tensor]
                   ) -> fused_mod.FusedLatResult:
        """Decode → trim → latent pass on the device for rows padded to one
        TEXT_BUCKET, with the engine's num_beams."""
        x = self._text_batch(rows)
        return fused_mod.synthesize_fused_lat(
            self.params["gpt"], self.gpt_cfg, sc, conds, x["ids"], x["pos"],
            x["seg"], x["cond_idx"], x["text"], x["text_lens"],
            self._generator, live, num_beams=self._num_beams,
            length_penalty=self._length_penalty)

    def synthesize_fused(self, conds: torch.Tensor,
                         token_rows: List[np.ndarray], sc: SamplingConfig,
                         spk: torch.Tensor, live: Optional[torch.Tensor] = None,
                         num_windows: Optional[int] = None, emit: str = "f32",
                         times: Optional[StageTimes] = None
                         ) -> Tuple[np.ndarray, fused_mod.FusedResult]:
        """The one-program flavour: decode → trim → latent pass → static
        window plan → vocode, with the engine's num_beams. Rows are padded
        to one TEXT_BUCKET; ``live`` marks batch-padding rows dead;
        ``num_windows`` overrides the plan's window count
        ceil(n·steps/window). Returns (wav cropped to the stream, float32
        for ``emit="f32"`` or the device's int16 for "i16", FusedResult).
        A stream shorter than window + 2·halo is re-vocoded at its exact
        length by ``WindowedVocoder.__call__``, as the JAX engine does.
        ``times``: its gpt_gen takes decode to latent pass, its bigvgan the
        vocoder."""
        times = times if times is not None else StageTimes()
        voc = self.vocoder
        if num_windows is None:
            num_windows = -(-len(token_rows) * sc.max_mel_tokens // voc.window)
        t0 = time.perf_counter()
        lat_res = self._fused_lat(conds, token_rows, sc, live)
        if self.device.type == "cuda":     # so the clock covers the decode
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        times.gpt_gen += t1 - t0
        res = fused_mod.vocode_fused(voc, lat_res, spk, num_windows)
        t = int(res.stream_frames)                  # the one host sync
        up = voc.upsample
        if t < voc.window + 2 * voc.halo:
            # a stream shorter than one full window: the plan's halo would
            # read junk where the true boundary is, so re-vocode the stream
            # at its exact length
            lens = res.lens.cpu().numpy()
            latnp = res.lat.float().cpu().numpy()
            stream = np.concatenate(
                [latnp[i, : lens[i]] for i in range(len(token_rows))], axis=0)
            wav = voc(stream, spk=spk[:1])
            if emit == "i16":
                wav = _to_i16(wav)
        else:
            wav = (res.wav_i16 if emit == "i16" else res.wav)[: t * up]
            wav = wav.cpu().numpy()
        times.bigvgan += time.perf_counter() - t1
        return wav, res

    def _synthesize_fused_public(self, conds: torch.Tensor,
                                 rows: List[np.ndarray], sc: SamplingConfig,
                                 spk: torch.Tensor, times: StageTimes
                                 ) -> Tuple[np.ndarray, np.ndarray]:
        """The fused route for the public surfaces: the batch padded to a
        FUSED_BATCH_BUCKET with dead rows. Above FUSED_FULL_VOCODE_MAX_STEPS
        decode → trim → latent on the device, then the streamed vocoder
        (float32 wav); at or below it the one-program flavour (int16 wav
        from the device). Returns (wav, latent frames per real row)."""
        n_real = len(rows)
        rows, live = self._pad_batch(rows)
        if sc.max_mel_tokens > self.FUSED_FULL_VOCODE_MAX_STEPS:
            t0 = time.perf_counter()
            res = self._fused_lat(conds, rows, sc, live)
            lens_all = res.lens.cpu().numpy()        # the one host sync
            times.gpt_gen += time.perf_counter() - t0
            times.decode_steps += res.steps
            self.last_fused_res = res
            self.last_fused_flavor = "fused+stream"
            t0 = time.perf_counter()
            wav = self.vocoder.stream_device(res.lat, lens_all,
                                             order=np.arange(n_real), spk=spk)
            times.bigvgan += time.perf_counter() - t0
            self.last_wav = wav
            self.last_sentence_frames = lens_all[:n_real]
            return wav, lens_all[:n_real]
        # the static window count sized by the live rows (dead rows emit no
        # frames), rounded up to a multiple of 8, at most the padded batch's
        steps = sc.max_mel_tokens
        window = self.vocoder.window
        nw_pad = -(-len(rows) * steps // window)
        nw_real = -(-n_real * steps // window)
        num_windows = min(nw_pad, _round_up(nw_real, 8))
        wav, res = self.synthesize_fused(conds, rows, sc, spk, live=live,
                                         num_windows=num_windows, emit="i16",
                                         times=times)
        times.decode_steps += res.steps
        self.last_fused_res = res
        self.last_fused_flavor = "fused"
        lens = res.lens[:n_real].cpu().numpy()
        # the float32 wav stays on the device (last_fused_res.wav)
        self.last_wav = None
        self.last_sentence_frames = lens
        return wav[: int(lens.sum()) * self.vocoder.upsample], lens

    # -- public entry points ---------------------------------------------
    def _set_gr_progress(self, value, desc):
        if self.gr_progress is not None:
            self.gr_progress(value, desc=desc)

    def _speaker(self, cond_mel: torch.Tensor) -> torch.Tensor:
        return self.vocoder.speaker_embedding(cond_mel.transpose(1, 2))

    def infer(self, audio_prompt, text, output_path=None, verbose=False,
              max_text_tokens_per_sentence=120, **generation_kwargs):
        """Sequential per-sentence synthesis (reference infer): one decode
        per sentence, then one latent pass and one streamed vocode over the
        collected rows. Returns (sample_rate, int16 (T, 1)) or writes
        ``output_path``."""
        start_time = time.perf_counter()
        self._set_gr_progress(0, "start inference...")
        times = StageTimes()
        cond_mel = self._cond_mel(audio_prompt)
        conds = self._conditioning(cond_mel)
        sc = self._sampling_config(generation_kwargs)
        times.decode = self._decode_name(sc)

        self._set_gr_progress(0.1, "text processing...")
        tokens = self.tokenizer.tokenize(text)
        sentences = self.tokenizer.split_sentences(
            tokens, max_text_tokens_per_sentence)
        if verbose:
            print(f">> {len(tokens)} tokens, {len(sentences)} sentences")
        sr = self.cfg.mel.sample_rate
        spk = self._speaker(cond_mel)
        lat_rows: List[Tuple[np.ndarray, np.ndarray, int]] = []
        for si, sent in enumerate(sentences):
            self._set_gr_progress(
                0.2 + 0.6 * si / max(len(sentences), 1),
                f"gpt inference speech... {si + 1}/{len(sentences)}")
            ids = self._ids(sent)
            t0 = time.perf_counter()
            res, _ = self._decode_batch_async(conds, [ids], sc)
            codes = res.codes.cpu().numpy()
            times.gpt_gen += time.perf_counter() - t0
            times.decode_steps += res.steps
            lat_rows += self._latent_rows(codes, [ids])
        wav = self._vocode_rows(conds, lat_rows, None, spk, times)
        self._set_gr_progress(0.9, "save audio...")
        wav = _to_i16(wav)
        times.total = time.perf_counter() - start_time
        times.audio_seconds = wav.size / sr
        self._report(times)
        return self._emit(wav, sr, output_path)

    def _vocode_rows(self, conds, lat_rows, stream_idx, spk, times,
                     progress: bool = False) -> np.ndarray:
        """Latent pass over ``lat_rows`` (timed as gpt_forward), then one
        streamed vocode of them in the order of ``stream_idx`` (each row's
        sentence index; None: as given). Float32 wav; records each
        sentence's frames and the wav."""
        if progress:
            self._set_gr_progress(0.5, "gpt inference latents...")
        if lat_rows:
            t0 = time.perf_counter()
            lat, lens, inv = self._latents_batch_device(conds, lat_rows)
            times.gpt_forward += time.perf_counter() - t0
        if progress:
            self._set_gr_progress(0.7, "bigvgan decode...")
        if not lat_rows:
            self.last_sentence_frames = np.zeros(0, np.int64)
            self.last_wav = np.zeros(0, np.float32)
            return self.last_wav
        order = inv if stream_idx is None else inv[np.argsort(stream_idx)]
        self.last_sentence_frames = lens[order]
        t0 = time.perf_counter()
        wav = self.vocoder.stream_device(lat, lens, order=order, spk=spk)
        times.bigvgan += time.perf_counter() - t0
        self.last_wav = wav
        return wav

    def infer_fast(self, audio_prompt, text, output_path=None, verbose=False,
                   max_text_tokens_per_sentence=100,
                   sentences_bucket_max_size=4, **generation_kwargs):
        """Bucketed batched synthesis (reference infer_fast): the fused route
        when ``_fused_eligible`` accepts the sentences, else the staged one.
        Returns (sample_rate, int16 (T, 1)) or writes ``output_path``."""
        start_time = time.perf_counter()
        self._set_gr_progress(0, "start fast inference...")
        times = StageTimes()
        cond_mel = self._cond_mel(audio_prompt)
        conds = self._conditioning(cond_mel)
        sc = self._sampling_config(generation_kwargs)
        times.decode = self._decode_name(sc)

        self._set_gr_progress(0.1, "text processing...")
        sentences = self.tokenizer.split_sentences(
            self.tokenizer.tokenize(text), max_text_tokens_per_sentence)
        sr = self.cfg.mel.sample_rate
        spk = self._speaker(cond_mel)
        sent_rows = [self._ids(s) for s in sentences]
        if self._fused_eligible(sent_rows):
            self._set_gr_progress(0.2, "gpt inference speech (fused)...")
            wav, _ = self._synthesize_fused_public(conds, sent_rows, sc, spk,
                                                   times)
            self._set_gr_progress(0.9, "save audio...")
            if wav.dtype != np.int16:   # the fused+stream flavour emits f32
                wav = _to_i16(wav)
            times.total = time.perf_counter() - start_time
            times.audio_seconds = wav.size / sr
            self._report(times, fast=True, path="fused")
            return self._emit(wav, sr, output_path)

        # a text with no sentence leaves one empty bucket, which decodes
        # nothing (the JAX engine raises on it)
        buckets = [b for b in bucket_sentences(
            sentences, bucket_max_size=sentences_bucket_max_size) if b]
        if verbose:
            print(f">> {len(sentences)} sentences in {len(buckets)} buckets")
        # every bucket's decode runs before any is read back: on the card
        # the host trims bucket k while the device finishes bucket k+1
        t0 = time.perf_counter()
        pending = []
        for bucket in buckets:
            rows = [self._ids(item["sent"]) for item in bucket]
            pending.append((bucket, rows,
                            self._decode_batch_async(conds, rows, sc)))
        all_idx: List[int] = []
        lat_rows: List[Tuple[np.ndarray, np.ndarray, int]] = []
        for bi, (bucket, rows, (res, n_real)) in enumerate(pending):
            self._set_gr_progress(
                0.2 + 0.3 * bi / max(len(pending), 1),
                f"gpt inference speech... {bi + 1}/{len(pending)}")
            codes = res.codes[:n_real].cpu().numpy()
            times.decode_steps += res.steps
            all_idx += [item["idx"] for item in bucket]
            lat_rows += self._latent_rows(codes, rows)
        times.gpt_gen += time.perf_counter() - t0
        wav = self._vocode_rows(conds, lat_rows, all_idx, spk, times,
                                progress=True)
        self._set_gr_progress(0.9, "save audio...")
        wav = _to_i16(wav)
        times.total = time.perf_counter() - start_time
        times.audio_seconds = wav.size / sr
        self._report(times, fast=True)
        return self._emit(wav, sr, output_path)

    def infer_batch(self, audio_prompt, texts: Sequence[str], verbose=False,
                    max_text_tokens_per_sentence=120, continuous=False,
                    cb_slots=8, **generation_kwargs
                    ) -> List[Tuple[int, np.ndarray]]:
        """Batched multi-utterance synthesis: every text's sentences decode
        together, on the fused route when ``_fused_eligible`` accepts them
        all, else bucketed by 8 on the staged route; the audio is cut back
        per text. ``continuous``: the staged route with every sentence
        through ``cb_slots`` continuous-batching slots instead of the
        buckets (sampling or greedy per row; num_beams is ignored, as in
        the JAX engine). Returns [(sample_rate, int16 (T, 1))] per text."""
        start_time = time.perf_counter()
        times = StageTimes()
        cond_mel = self._cond_mel(audio_prompt)
        conds = self._conditioning(cond_mel)
        sc = self._sampling_config(generation_kwargs)
        times.decode = self._decode_name(sc)
        sr = self.cfg.mel.sample_rate
        spk = self._speaker(cond_mel)

        # texts → sentences with the index of the text that owns each; a
        # text with no sentence keeps one empty sentence
        flat_sents: List[List[str]] = []
        owners: List[int] = []
        for ti, text in enumerate(texts):
            sents = self.tokenizer.split_sentences(
                self.tokenizer.tokenize(text),
                max_text_tokens_per_sentence) or [[]]
            flat_sents += sents
            owners += [ti] * len(sents)

        flat_rows = [self._ids(s) for s in flat_sents]
        if not continuous and self._fused_eligible(flat_rows):
            # sentences are contiguous per text in flat order, so each text
            # is a slice of the stream at its frame offsets
            wav, lens = self._synthesize_fused_public(conds, flat_rows, sc,
                                                      spk, times)
            if wav.dtype != np.int16:   # the fused+stream flavour emits f32
                wav = _to_i16(wav)
            bounds = np.concatenate([[0], np.cumsum(lens)]) * self.vocoder.upsample
            outs = []
            for ti in range(len(texts)):
                sids = [si for si, o in enumerate(owners) if o == ti]
                seg = wav[int(bounds[sids[0]]): int(bounds[sids[-1] + 1])]
                outs.append((sr, seg[:, None]))
            times.total = time.perf_counter() - start_time
            times.audio_seconds = sum(w.shape[0] for _, w in outs) / sr
            self._report(times, fast=True, path="fused")
            return outs

        t0 = time.perf_counter()
        sent_ids: List[int] = []
        lat_rows: List[Tuple[np.ndarray, np.ndarray, int]] = []
        pending = []
        if continuous:
            # every sentence is one request; an empty one decodes as [2]
            rows = [r if r.size else np.array([2], np.int32)
                    for r in flat_rows]
            codes, _ = self._decode_continuous(conds, rows, sc, batch=cb_slots)
            stats = self.last_cb_stats
            times.decode = (f"{'sampling' if sc.do_sample else 'greedy'} "
                            f"(continuous batching, {stats['slots']} slots)")
            times.decode_steps += stats["steps"]
            sent_ids = list(range(len(rows)))
            lat_rows = self._latent_rows(codes, rows)
            times.gpt_gen += time.perf_counter() - t0
        else:
            for bucket in bucket_sentences(flat_sents, bucket_max_size=8):
                rows = [self._ids(item["sent"]) for item in bucket]
                if not rows or all(r.size == 0 for r in rows):
                    continue
                # an empty sentence in a bucket with others decodes as one
                # token
                rows = [r if r.size else np.array([2], np.int32)
                        for r in rows]
                pending.append((bucket, rows,
                                self._decode_batch_async(conds, rows, sc)))
        for bucket, rows, (res, n_real) in pending:
            codes = res.codes[:n_real].cpu().numpy()
            times.decode_steps += res.steps
            sent_ids += [item["idx"] for item in bucket]
            lat_rows += self._latent_rows(codes, rows)
        if pending:
            times.gpt_gen += time.perf_counter() - t0
        frames = np.zeros(len(flat_sents), np.int64)
        if lat_rows:
            t0 = time.perf_counter()
            lat, lens, inv = self._latents_batch_device(conds, lat_rows)
            times.gpt_forward += time.perf_counter() - t0
            # input row i (sentence sent_ids[i]) lives in lat row inv[i]
            row_of_sent = dict(zip(sent_ids, inv))
            frames[sent_ids] = lens[inv]
        else:
            row_of_sent = {}
        self.last_sentence_frames = frames

        outs: List[Tuple[int, np.ndarray]] = []
        floats = []
        for ti in range(len(texts)):
            order = np.asarray([row_of_sent[si] for si, o in enumerate(owners)
                                if o == ti and si in row_of_sent], np.int64)
            if order.size == 0:
                outs.append((sr, np.zeros((0, 1), np.int16)))
                continue
            t0 = time.perf_counter()
            wav = self.vocoder.stream_device(lat, lens, order=order, spk=spk)
            times.bigvgan += time.perf_counter() - t0
            floats.append(wav)
            outs.append((sr, _to_i16(wav)[:, None]))
        self.last_wav = np.concatenate(floats or [np.zeros(0, np.float32)])
        times.total = time.perf_counter() - start_time
        times.audio_seconds = sum(w.shape[0] for _, w in outs) / sr
        self._report(times, fast=True)
        return outs

    # ------------------------------------------------------------------
    def _report(self, times: StageTimes, fast: bool = False,
                path: str = "staged") -> None:
        tag = "[fast] " if fast else ""
        if path == "fused":
            # the whole fused route's time; the port's split follows
            flavor = self.last_fused_flavor
            note = ("decode+trim+latent+vocode on the device, static window "
                    "plan" if flavor == "fused"
                    else "decode+trim+latent on the device + streamed vocode")
            print(f">> {tag}synthesis path: fused ({note})")
            print(f">> {tag}fused_time: {times.gpt_gen + times.bigvgan:.2f} s")
        elif fast:
            print(f">> {tag}synthesis path: staged")
        print(f">> {tag}decode: {times.decode}, {times.decode_steps} steps")
        print(f">> {tag}gpt_gen_time: {times.gpt_gen:.2f} s")
        if path != "fused":
            # the latent pass is only queued: its device time lands in the
            # vocoder's wall
            lat_note = (" (dispatch only; compute folded into bigvgan)"
                        if fast else "")
            print(f">> {tag}gpt_forward_time: {times.gpt_forward:.2f} s"
                  f"{lat_note}")
        print(f">> {tag}bigvgan_time: {times.bigvgan:.2f} s")
        print(f">> {tag}Total inference time: {times.total:.2f} s")
        print(f">> {tag}Generated audio length: {times.audio_seconds:.2f} s")
        print(f">> {tag}RTF: {times.rtf:.4f}")
        self.last_times = times
        self.last_path = path

    def _emit(self, wav_i16: np.ndarray, sr: int, output_path):
        if output_path:
            audio_util.write_wav(output_path, wav_i16, sr)
            return output_path
        return sr, wav_i16[:, None]
