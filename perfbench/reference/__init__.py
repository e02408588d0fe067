"""The plain reference of IndexTTS that decides ``correct``.

Plain PyTorch only: frozen copies of the port's plain model code (mel,
conformer, perceiver, ECAPA, BigVGAN's exact route) and a GPT written for
full sequences (``gpt.py``). It imports neither JAX nor anything of the
program, and it takes nothing the program made: it reads the prompt wav
from its file, tokenizes the texts itself, trims the served codes itself,
and works the conditioning, the speaker embedding, the latents and the
stream's waveform out again from the weights the benchmark drew.

The waveform follows the engine's vocoding plan, which the configuration
states (``vocoder``): a stream of at most window + 2·halo frames is
vocoded whole; a longer one in windows of ``window`` frames, each
vocoded with ``halo`` frames of context on either side (clamped inside the
stream) and cut back to its own frames. Every window runs BigVGAN's exact
route.

``Reference(params, cfg, dtype)`` computes in ``dtype`` (float32 for the
reference, a lower precision for the control); its matmuls and
convolutions take TF32 only with ``tf32=True`` (a control), or where
``vocode_i16(..., tf32=True)`` asks for it (the check's unit of rounding).
"""
from __future__ import annotations

import contextlib
import wave
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference import bigvgan, ecapa, gpt
from perfbench.reference.mel import MelSpectrogram

SILENT_TOKEN = 52


def read_wav_mono(path) -> Tuple[np.ndarray, int]:
    """A 16-bit PCM wav → (float32 channel mean (T,), sample rate)."""
    with wave.open(str(path), "rb") as w:
        sr, ch, width = w.getframerate(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width != 2:
        raise ValueError(f"{path}: expected 16-bit PCM")
    data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    return data.reshape(-1, ch).mean(axis=1), sr


def text_ids(text: str, vocab: int) -> np.ndarray:
    """IndexTTS's character tokenizer (the fallback when no BPE model ships)
    on lowercase letters and '.': ``2 + ord(c) % (vocab - 3)`` for each
    character that is not a space."""
    return np.asarray([2 + ord(c) % (vocab - 3) for c in text
                       if not c.isspace()], np.int64)


def trim_codes(codes: np.ndarray, stop: int, silent: int = SILENT_TOKEN,
               max_consecutive: int = 30) -> np.ndarray:
    """IndexTTS's silence trim of one row: cut at the first stop code; a
    row with more than ``max_consecutive`` silent codes keeps at most 10 of
    each run of them."""
    codes = np.asarray(codes)
    stops = np.nonzero(codes == stop)[0]
    row = codes[: int(stops[0]) if stops.size else codes.size]
    if int(np.sum(codes == silent)) <= max_consecutive:
        return row
    kept, run = [], 0
    for c in row:
        if c != silent:
            kept.append(c)
            run = 0
        elif run < 10:
            kept.append(c)
            run += 1
    return np.asarray(kept, codes.dtype)


def to_i16(wav: np.ndarray) -> np.ndarray:
    """IndexTTS's output scaling: clip(wav·32767) truncated to int16."""
    return np.clip(wav * 32767.0, -32767.0, 32767.0).astype(np.int16)


@contextlib.contextmanager
def tf32_mode(enabled: bool):
    """TF32 on or off for CUDA matmuls and cuDNN convolutions, restored on
    leaving."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _bigvgan_cfg(b: Dict[str, Any]) -> SimpleNamespace:
    return SimpleNamespace(
        num_upsamples=len(b["upsample_rates"]),
        num_kernels=len(b["resblock_kernel_sizes"]),
        upsample_rates=tuple(b["upsample_rates"]),
        upsample_kernel_sizes=tuple(b["upsample_kernel_sizes"]),
        resblock_kernel_sizes=tuple(b["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in
                                      b["resblock_dilation_sizes"]),
        activation=b["activation"], snake_logscale=b["snake_logscale"],
        cond_in_each_up_layer=b["cond_in_each_up_layer"])


class Reference:
    """IndexTTS on one prompt: decode logits, latents and the waveform of
    served codes."""

    def __init__(self, params: Dict[str, Any], cfg: Dict[str, Any],
                 dtype: torch.dtype = torch.float32, tf32: bool = False):
        self.p = params
        self.tf32 = tf32
        self.g = cfg["gpt"]
        self.bcfg = _bigvgan_cfg(cfg["bigvgan"])
        self.mel_cfg = cfg["mel"]
        self.window = cfg["vocoder"]["window"]
        self.halo = cfg["vocoder"]["halo"]
        self.dtype = dtype
        self.device = params["gpt"]["mel_emb"]["w"].device

    def set_prompt(self, wav_path) -> None:
        wav, sr = read_wav_mono(wav_path)
        m = self.mel_cfg
        if sr != m["sample_rate"]:
            raise ValueError(f"prompt at {sr} Hz, the model takes "
                             f"{m['sample_rate']}")
        mel_fn = MelSpectrogram(
            sample_rate=m["sample_rate"], n_fft=m["n_fft"],
            hop_length=m["hop_length"], win_length=m["win_length"],
            n_mels=m["n_mels"], device=self.device)
        with tf32_mode(self.tf32):
            mel = mel_fn(wav).transpose(1, 2).to(self.dtype)   # (1, T, n_mels)
            self.conds = gpt.conditioning(self.p["gpt"], self.g, mel)
            self.spk = ecapa.forward(self.p["bigvgan"]["speaker_encoder"],
                                     mel)

    def decode_logits(self, text: str, codes: np.ndarray) -> torch.Tensor:
        """(n, V) float32 logits before each of the served ``codes``."""
        ids = torch.as_tensor(text_ids(text, self.g["number_text_tokens"]),
                              device=self.device)
        with tf32_mode(self.tf32):
            return gpt.decode_logits(self.p["gpt"], self.g, self.conds, ids,
                                     torch.as_tensor(codes,
                                                     device=self.device))

    def stream_latents(self, rows: Sequence[Tuple[str, np.ndarray]]
                       ) -> torch.Tensor:
        """Served rows (text, raw codes) → the latent stream (T, C) of their
        trimmed codes in row order (T may be 0)."""
        lats: List[torch.Tensor] = []
        with tf32_mode(self.tf32):
            for text, codes in rows:
                kept = trim_codes(codes, self.g["stop_mel_token"])
                if kept.size == 0:
                    continue
                ids = torch.as_tensor(
                    text_ids(text, self.g["number_text_tokens"]),
                    device=self.device)
                lats.append(gpt.latents(self.p["gpt"], self.g, self.conds,
                                        ids, torch.as_tensor(
                                            kept, device=self.device)))
        if not lats:
            return torch.zeros((0, self.g["model_dim"]), device=self.device)
        return torch.cat(lats).to(self.dtype)

    def vocode_i16(self, lat: torch.Tensor, tf32: Optional[bool] = None
                   ) -> np.ndarray:
        """A latent stream → its int16 waveform by the engine's plan; TF32
        as the reference was built unless ``tf32`` says otherwise."""
        if lat.shape[0] == 0:
            return np.zeros(0, np.int16)
        with tf32_mode(self.tf32 if tf32 is None else tf32):
            wav = self._vocode(lat)
        return to_i16(wav.float().cpu().numpy())

    def _vocode(self, lat: torch.Tensor, batch: int = 8) -> torch.Tensor:
        """A latent stream (T, C) → its waveform (T·1024,) by the plan."""
        t, w, h = lat.shape[0], self.window, self.halo
        spk = self.spk.to(self.dtype)
        gen = lambda x: bigvgan.generate(self.p["bigvgan"], self.bcfg, x,
                                         spk.expand(x.shape[0], -1, -1))
        if t <= w + 2 * h:
            return gen(lat[None])[0]
        wins = [(s, min(s + w, t), min(max(0, s - h), t - w - 2 * h))
                for s in range(0, t, w)]
        up = int(np.prod(self.bcfg.upsample_rates))
        out = []
        for i in range(0, len(wins), batch):
            chunk = wins[i: i + batch]
            wavs = gen(torch.stack([lat[lo: lo + w + 2 * h]
                                    for _, _, lo in chunk]))
            out += [wv[(s - lo) * up: (e - lo) * up]
                    for wv, (s, e, lo) in zip(wavs, chunk)]
        return torch.cat(out)
