"""The plain reference of IndexTTS-2 that decides ``correct`` in an
IndexTTS-2 cell.

Plain PyTorch, float32 unless told otherwise, TF32 off unless told
otherwise (``tf32_mode``), one line at a time: no cache, no batching, no
graphs, no kernel of the program. It imports neither JAX nor anything of
the program and takes nothing the program made but the served codes and
the served mel: it reads the prompt from its file, tokenizes the texts
itself and draws each line's noise from the line's seed.

Each stage follows the public source (index-tts ``indextts/infer_v2.py``
and ``indextts/gpt/model_v2.py``; the blocks' own sources are named in
``v2_front.py`` and ``v2_s2m.py``):

- the voice (``set_prompt``): the prompt at 22 050 Hz, torchaudio's
  resampler to 16 kHz, ``SeamlessM4TFeatureExtractor``'s features,
  w2v-BERT 2.0's ``hidden_states[17]`` normalised by its stats, the
  semantic codec's quantized embeddings, BigVGAN's 80-band log-mel
  (``perfbench/reference/f5tts.bigvgan_mel``), CAM++'s style of the Kaldi
  fbank less its mean, and the length regulator's prompt condition;
- the GPT's conditioning rows (``model_v2.py``: ``get_conditioning``,
  ``get_emo_conditioning``, ``merge_emovec`` with the speaker prompt as
  the emotion prompt and ``alpha`` 1, ``inference_speech``'s
  ``[latents + emo_vec, speed_emb(1), speed_emb(0)]``) on IndexTTS's
  conformer and perceiver (``conformer.py``, ``perceiver.py``);
- ``decode_logits``: the logits decoding saw before each served code, one
  causal pass over the prompt and the served codes (``gpt.decode_logits``,
  the v1.5 GPT's equations, which v2's ``UnifiedVoice`` keeps);
- ``mel``: the latent pass (``gpt.latents``: ``UnifiedVoice.forward``'s
  mel latents), ``gpt_layer``, ``vq2emb`` of the codes, the regulator to
  ``int(len · 1.72)`` frames, the prompt's condition before it, and the
  CFM's ``solve_euler`` over the whole row from the given noise;
- ``vocode_i16``: BigVGAN-v2 22 kHz ×256 over a whole line
  (``f5tts.vocode``), clamped, times 32767, int16.
"""
from __future__ import annotations

import wave
from typing import Any, Dict

import numpy as np
import torch

from perfbench.reference import _bigvgan_cfg, conformer, gpt, perceiver
from perfbench.reference import nn, text_ids, tf32_mode, to_i16
from perfbench.reference import v2_front as front
from perfbench.reference import v2_s2m
from perfbench.reference.f5tts import bigvgan_mel, vocode

Params = Dict[str, Any]


def frames_of(codes: int, per_code: float) -> int:
    """``(code_lens * 1.72).long()`` on a LongTensor: a float32 product,
    truncated."""
    return int((torch.tensor([codes]) * per_code).long()[0])


class V2Reference:
    """IndexTTS-2 on one prompt: decode logits, the mel of served codes
    from a given noise, the int16 waveform of a mel."""

    def __init__(self, params: Params, cfg: Dict[str, Any],
                 dtype: torch.dtype = torch.float32, tf32: bool = False):
        self.p, self.cfg, self.dtype, self.tf32 = params, cfg, dtype, tf32
        self.g = cfg["gpt"]
        s, d = cfg["s2mel"], cfg["defaults"]
        self.s2m = dict(s, norm_eps=d["norm_eps"], rope_base=d["rope_base"])
        w = cfg["w2vbert"]
        self.w2v = {"heads": w["num_attention_heads"],
                    "left_max_position": w["left_max_position_embeddings"],
                    "right_max_position": w["right_max_position_embeddings"],
                    "conv_kernel": w["conv_depthwise_kernel_size"],
                    "out_layer": w["out_layer"], "eps": w["layer_norm_eps"]}
        self.bcfg = _bigvgan_cfg(cfg["vocoder"]["bigvgan"])
        self.device = params["gpt"]["mel_emb"]["w"].device

    def set_prompt(self, wav_path) -> None:
        with wave.open(str(wav_path), "rb") as w:
            sr = w.getframerate()
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        m = self.cfg["mel"]
        if sr != m["sample_rate"]:
            raise ValueError(f"prompt at {sr} Hz, the model takes "
                             f"{m['sample_rate']}")
        dt, p = self.dtype, self.p
        wav22 = torch.as_tensor(pcm.astype(np.float32) / 32768.0,
                                device=self.device)
        with tf32_mode(self.tf32):
            wav16 = front.resample(wav22, sr,
                                   self.cfg["sampler"]["semantic_rate"])
            feats = front.w2vbert(p["w2vbert"], self.w2v,
                                  front.seamless_features(wav16).to(dt))
            s_ref = front.codec_quantize(p["codec"], feats)
            self.ref_mel = bigvgan_mel(wav22, m)               # (Tp, 80)
            fb = front.fbank(wav16)
            self.style = front.campplus(
                p["campplus"], self.cfg["campplus"],
                (fb - fb.mean(dim=0, keepdim=True)).to(dt))
            self.prompt_cond = v2_s2m.regulate(p["s2m"]["regulator"], s_ref,
                                               self.ref_mel.shape[0])
            self.conds = self._conds(feats)

    def _conds(self, feats: torch.Tensor) -> torch.Tensor:
        g, v2, p = self.g, self.cfg["v2"], self.p["gpt"]
        lens = torch.tensor([feats.shape[1]], device=self.device)
        spk = gpt.conditioning(p, g, feats)

        def emo(f):
            x, keep = conformer.forward(p["emo_encoder"], f, lens,
                                        heads=v2["emo_attention_heads"])
            ones = torch.ones((1, 1), dtype=torch.bool, device=f.device)
            e = perceiver.forward(p["emo_perceiver"], x,
                                  torch.cat([ones, keep], 1),
                                  heads=v2["emo_attention_heads"])[:, 0]
            return nn.linear(p["emo_layer"], nn.linear(p["emovec_layer"], e))
        emo_vec, base_vec = emo(feats), emo(feats)
        out = base_vec + 1.0 * (emo_vec - base_vec)
        speed = p["speed_emb"]["w"]
        return torch.cat([spk + out[:, None], speed[1][None, None],
                          speed[0][None, None]], dim=1)

    def ids(self, text: str) -> torch.Tensor:
        return torch.as_tensor(text_ids(text, self.g["number_text_tokens"]),
                               device=self.device)

    def decode_logits(self, text: str, codes: np.ndarray) -> torch.Tensor:
        """(n, V) float32 logits before each of the served ``codes``."""
        with tf32_mode(self.tf32):
            return gpt.decode_logits(self.p["gpt"], self.g, self.conds,
                                     self.ids(text), torch.as_tensor(
                                         codes, device=self.device))

    def frames(self, n_codes: int) -> int:
        """A row's frames: the prompt's and its codes' regulated."""
        return self.ref_mel.shape[0] + frames_of(
            n_codes, self.cfg["sampler"]["frames_per_code"])

    def noise(self, seed: int, n: int) -> torch.Tensor:
        """A row's ODE start: (n, 80) float32 N(0, 1) from a generator on
        the reference's device seeded with ``seed`` (row i of a call with
        seed s draws from s + i)."""
        g = torch.Generator(self.device).manual_seed(int(seed))
        return torch.randn((n, self.s2m["in_channels"]), generator=g,
                           device=self.device)

    def mel(self, text: str, codes: np.ndarray, noise: torch.Tensor
            ) -> torch.Tensor:
        """The row's mel (n, 80) float32 from its served codes and noise
        (n, 80), n = ``frames(len(codes))``; prompt frames 0."""
        p, s, dt = self.p, self.cfg["sampler"], self.dtype
        c = torch.as_tensor(codes, device=self.device).long()
        with tf32_mode(self.tf32):
            lat = gpt.latents(p["gpt"], self.g, self.conds, self.ids(text), c)
            feats = v2_s2m.gpt_layer(p["s2m"]["gpt_layer"], lat.to(dt)) \
                + front.vq2emb(p["codec"], c).to(dt)
            ylen = frames_of(c.numel(), s["frames_per_code"])
            cond = v2_s2m.regulate(p["s2m"]["regulator"], feats[None], ylen)
            mu = torch.cat([self.prompt_cond, cond], dim=1)
            out = v2_s2m.cfm(p["s2m"]["dit"], self.s2m, mu,
                             self.ref_mel.T[None].to(dt), self.style,
                             noise.T[None].to(dt), s["diffusion_steps"],
                             s["inference_cfg_rate"])
        return out[0].T.float()

    def vocode_i16(self, mel: torch.Tensor, tf32=None) -> np.ndarray:
        """A line's generated mel (T, 80) → its int16 wav; TF32 as the
        reference was built unless ``tf32`` says otherwise."""
        if mel.shape[0] == 0:
            return np.zeros(0, np.int16)
        with tf32_mode(self.tf32 if tf32 is None else tf32):
            wav = vocode(self.p["vocoder"], self.bcfg,
                         mel[None].to(self.dtype))[0]
        return to_i16(wav.float().cpu().numpy())
