"""IndexTTS-2 on the port: the family of a configuration with
``"family": "indextts2"``.

The program is ``IndexTTS2`` of ``index_tts_dubbing_tpu_torch`` on weights
drawn from the seed, served through ``infer_batch`` (one call a scene:
every line of the mix's slot at the slot's cap) or ``infer`` (a one-line
slot), decoding by beam sampling with the mix's settings. The weights are
the port's tree (``weights.indextts2_tree``) drawn on the device from the
seed, the GPT and the S2M in the configuration's dtype; the reference reads
the same values in float32. The check runs the plain reference
(``perfbench/reference/indextts2.py``) over the compared calls:

- ``code_gap``: as IndexTTS's (``perfbench/check.py``), teacher-forced
  along each served row: the widest gap by which a served code's
  beam-sampling score (log-softmax, the repetition penalty, the
  temperature) lies below the lowest score its ancestor's top-k / top-p
  set keeps, the reference's full forward pass in the cached decode's
  place. It covers the front end, both conditioners, the duration rows,
  the prefill and the graphed decode with K3;
- ``mel_err``: over the call's rows, the largest relative L2 error of the
  generated frames the program sampled (its ``last_mel``, prompt frames
  left out) against the reference's S2M from the served codes and the
  noise the reference draws itself from the row's seed (``noise_seed`` of
  the call, plus the row's place), at the frames the reference works out
  from the codes. Another frame count, or a start other than that noise
  bit for bit, reads infinite. It covers the latent pass, ``gpt_layer``,
  ``vq2emb``, the regulator, the DiT and its WaveNet head, the guidance,
  every Euler step, the prompt frames held and the rows' seeding;
- ``wav_ratio``: as F5's, the relative L2 error of the call's int16
  waveform against the reference's exact vocoding of the program's own
  generated mel, row by row, over ``wav_unit``. It covers the window plan,
  K1, K2, the exact patches and the emission.

``compared`` counts the served codes read. The interface is
``perfbench/families/__init__.py``'s.
"""
from __future__ import annotations

import contextlib
import gc
import os
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from perfbench import check, harness, traffic
from perfbench.families.indextts import fp8_weights, trace_hook  # noqa: F401
from perfbench.reference.indextts2 import V2Reference
from perfbench.weights import cast

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ENTRIES = ("infer", "infer_batch")
CALL_COLUMNS = "rows steps gpt_gen_s s2m_s bigvgan_s"
DECODE = {"do_sample", "num_beams", "top_k", "top_p", "temperature",
          "length_penalty", "repetition_penalty"}


def check_mix(mix: Dict[str, Any], path) -> None:
    d = mix.get("decode")
    if d is None or set(d) != DECODE:
        raise ValueError(f"{path}: 'decode' gives IndexTTS-2's generation "
                         f"settings, {sorted(DECODE)}")
    if mix["entry"] not in ENTRIES:
        raise ValueError(f"{path}: unknown entry {mix['entry']!r}")
    if not (d["do_sample"] and d["num_beams"] > 1):
        raise ValueError(f"{path}: the check reads beam sampling only "
                         f"(do_sample and num_beams > 1)")
    if float(d["repetition_penalty"]) != check.REPETITION_PENALTY:
        raise ValueError(f"{path}: the check reads a repetition penalty of "
                         f"{check.REPETITION_PENALTY}")
    if mix["entry"] == "infer" and any(len(s["chars"]) != 1
                                       for s in mix["slots"]):
        raise ValueError(f"{path}: an 'infer' slot has one text")


def call_kwargs(mix: Dict[str, Any], slot: int) -> Dict[str, Any]:
    return dict(mix["decode"], max_mel_tokens=int(mix["slots"][slot]["cap"]))


def noise_seed(seed: int, index: int) -> int:
    """The seed of a call's ODE noise."""
    return int(np.random.default_rng([int(seed), 7, abs(int(index))])
               .integers(2**62))


def v2_config(cfg: Dict[str, Any]):
    """The port's ``IndexTTS2Config`` of a configuration file."""
    from index_tts_dubbing_tpu_torch.config import (
        CAMPPlusConfig, CodecConfig, GPTConfig, IndexTTS2Config, MelConfig,
        MelVocoderConfig, S2MConfig, W2VBertConfig)
    b = dict(cfg["vocoder"]["bigvgan"])
    for key in ("upsample_rates", "upsample_kernel_sizes",
                "resblock_kernel_sizes"):
        b[key] = tuple(b[key])
    b["resblock_dilation_sizes"] = tuple(tuple(d) for d in
                                         b["resblock_dilation_sizes"])
    w, s, c, d = cfg["w2vbert"], cfg["s2mel"], cfg["campplus"], \
        cfg["defaults"]
    v2 = {k: v for k, v in cfg["v2"].items() if k != "about"}
    return IndexTTS2Config(
        gpt=GPTConfig(**cfg["gpt"]), **v2,
        w2vbert=W2VBertConfig(
            hidden=w["hidden_size"], layers=w["num_hidden_layers"],
            out_layer=w["out_layer"], heads=w["num_attention_heads"],
            intermediate=w["intermediate_size"],
            feature_dim=w["feature_projection_input_dim"],
            conv_kernel=w["conv_depthwise_kernel_size"],
            left_max_position=w["left_max_position_embeddings"],
            right_max_position=w["right_max_position_embeddings"],
            eps=w["layer_norm_eps"]),
        codec=CodecConfig(**cfg["semantic_codec"]),
        campplus=CAMPPlusConfig(
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in c.items() if k != "about"}),
        s2m=S2MConfig(
            in_channels=s["in_channels"], hidden_dim=s["hidden_dim"],
            num_heads=s["num_heads"], depth=s["depth"],
            intermediate=cfg["assumed"]["s2mel_intermediate"]["value"],
            style_dim=s["style_dim"], content_dim=s["content_dim"],
            regulator_in=s["regulator_in"],
            regulator_blocks=s["regulator_blocks"],
            gpt_dim=s["gpt_layer"][0], gpt_layer=tuple(s["gpt_layer"][1:-1]),
            wavenet_hidden=s["wavenet_hidden"],
            wavenet_layers=s["wavenet_layers"],
            wavenet_kernel=s["wavenet_kernel"],
            time_freq_dim=d["time_freq_dim"], norm_eps=d["norm_eps"],
            rope_base=d["rope_base"]),
        vocoder=MelVocoderConfig(**b), mel=MelConfig(**cfg["mel"]),
        semantic_rate=cfg["sampler"]["semantic_rate"],
        frames_per_code=cfg["sampler"]["frames_per_code"],
        diffusion_steps=cfg["sampler"]["diffusion_steps"],
        cfg_rate=cfg["sampler"]["inference_cfg_rate"])


def make_weights(cfg: Dict[str, Any], seed: int, device, dtype
                 ) -> Dict[str, Any]:
    """The port's IndexTTS-2 tree drawn from ``seed`` on ``device``: the
    GPT and the S2M in ``dtype``, the rest in float32."""
    from index_tts_dubbing_tpu_torch import weights
    gen = torch.Generator(device).manual_seed(int(seed))
    tree = weights.indextts2_tree(weights.Init(gen, device), v2_config(cfg))
    for k in ("gpt", "s2m"):
        tree[k] = cast(tree[k], dtype)
    return tree


class Program:
    """The system under test: the port's IndexTTS-2 engine on the
    benchmark's weights and prompt."""

    def __init__(self, cell, seed: int, device, workdir: Path):
        from index_tts_dubbing_tpu_torch.engine.indextts2 import IndexTTS2
        cfg = cell.config
        self.cell, self.seed = cell, int(seed)
        self.dtype = cfg["dtype"]
        params = make_weights(cfg, seed, device, DTYPES[self.dtype])
        self.tts = IndexTTS2(config=v2_config(cfg), params=params,
                             is_fp16=self.dtype == "bfloat16", device=device,
                             seed=int(seed),
                             vocoder_window=cfg["vocoder"]["window"],
                             verbose_init=False)
        del params
        sr = cfg["mel"]["sample_rate"]
        self.prompt = workdir / "prompt.wav"
        harness.write_prompt(self.prompt,
                             traffic.prompt_wav(cell.mix, seed, sr), sr)
        self.cuda = torch.device(device).type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def serve(self, call: traffic.Call) -> Dict[str, Any]:
        tts = self.tts
        rec: Dict[str, Any] = {"index": call.index, "slot": call.slot,
                               "cap": call.cap, "texts": call.texts,
                               "error": None}
        seed = noise_seed(self.seed, call.index)
        rec["t0"] = time.perf_counter()
        try:
            with open(os.devnull, "w") as sink, \
                    contextlib.redirect_stdout(sink):
                if self.cell.mix["entry"] == "infer":
                    outs = [tts.infer(str(self.prompt), call.texts[0],
                                      seed=seed, **call.kwargs)]
                else:
                    outs = tts.infer_batch(str(self.prompt), call.texts,
                                           seed=seed, **call.kwargs)
        except Exception as e:                     # counted, not fatal
            rec["t1"] = time.perf_counter()
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["audio_s"] = 0.0
            return rec
        rec["t1"] = time.perf_counter()
        lt = tts.last_times
        rec.update(audio_s=lt.audio_seconds, gpt_gen=lt.gpt_gen, s2m=lt.s2m,
                   bigvgan=lt.bigvgan, steps=lt.decode_steps, nfe=lt.nfe,
                   beams=int(call.kwargs["num_beams"]),
                   wav=np.concatenate([w[:, 0] for _, w in outs]),
                   raw_codes=tts.last_raw_codes, rows=list(tts.last_rows),
                   frames=list(tts.last_frames),
                   prompt_frames=tts.last_prompt_frames,
                   mel=tts.last_mel, noise=tts.last_noise)
        return rec

    def free(self) -> None:
        del self.tts
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def control(params32, cfg):
    """The control: the reference one precision below the
    configuration's."""
    kind = cfg["control"]
    if kind == "fp8_weights_bf16":
        return V2Reference(fp8_weights(params32), cfg, torch.bfloat16)
    if kind == "bfloat16":
        return V2Reference(cast(params32, torch.bfloat16), cfg,
                           torch.bfloat16)
    raise ValueError(f"unknown control {kind!r}")


def _rel(got, want) -> float:
    return check.rel_err(np.asarray(got), np.asarray(want))


def _gap(ref, low, text, codes, decode, start, noise_gen) -> float:
    """``code_gap`` of one served row (``check.readings``'s rule); with
    ``low`` the control's pick in the program's place."""
    c = torch.as_tensor(codes, device=ref.device).long()
    warp = lambda lg: check.scores(lg, c, start, decode["temperature"])
    s = warp(ref.decode_logits(text, codes))
    pick = c
    if low is not None:
        sl = warp(low.decode_logits(text, codes))
        kept = sl >= check.boundary(sl, decode["top_k"],
                                    decode["top_p"])[:, None]
        u = torch.rand(sl.shape, generator=noise_gen,
                       device=ref.device).clamp_min(1e-30)
        pick = torch.where(kept, sl - torch.log(-torch.log(u)),
                           float("-inf")).argmax(-1)
    b = check.boundary(s, decode["top_k"], decode["top_p"])
    return float((b - s.gather(1, pick[:, None])[:, 0]).clamp_min(0).max())


def compare(records, idx, cfg, mix, seed: int, prompt, device,
            as_control: bool = False) -> Dict[str, Any]:
    """``code_gap``, ``mel_err`` and ``wav_ratio`` (module docstring) of
    the float32 reference on the seed's weights; with ``as_control`` the
    control's."""
    params = cast(make_weights(cfg, seed, device, DTYPES[cfg["dtype"]]),
                  torch.float32)
    ref = V2Reference(params, cfg)
    ref.set_prompt(prompt)
    low = None
    if as_control:
        low = control(params, cfg)
        low.set_prompt(prompt)
    g, decode = cfg["gpt"], mix["decode"]
    stop, start = g["stop_mel_token"], g["start_mel_token"]
    noise_gen = torch.Generator(device=ref.device)
    noise_gen.manual_seed(int(seed) % 2**63)
    tp = ref.ref_mel.shape[0]
    gap = mel_err = err = ratio = unit = 0.0
    tokens = 0
    for i in idx:
        r = records[i]
        if r["rows"] != list(range(len(r["texts"]))):
            gap = mel_err = err = ratio = float("inf")
            continue
        first = noise_seed(seed, r["index"])
        exact, tf32, low_wav, j = [], [], [], 0
        for row, text in enumerate(r["texts"]):
            raw = np.asarray(r["raw_codes"][row])
            n = check.served_length(raw, stop)
            gap = max(gap, _gap(ref, low, text, raw[:n], decode, start,
                                noise_gen))
            tokens += n
            codes = raw[: n - 1] if raw[n - 1] == stop else raw[:n]
            if codes.size == 0:
                continue
            m = ref.frames(codes.size)
            if (j >= len(r["frames"]) or r["frames"][j] != m
                    or r["prompt_frames"] != tp):
                mel_err = float("inf")
                j += 1
                continue
            noise = ref.noise(first + j, m)
            if not torch.equal(torch.as_tensor(r["noise"][j, :m]).cpu(),
                               noise.cpu()):
                mel_err = float("inf")
                j += 1
                continue
            got = np.asarray(r["mel"][j, tp:m], np.float64)
            want = ref.mel(text, codes, noise)[tp:]
            cmp = (low.mel(text, codes, noise)[tp:].cpu().numpy()
                   if low is not None else got)
            mel_err = max(mel_err, _rel(cmp, want.cpu().numpy()))
            served = torch.as_tensor(got, dtype=torch.float32,
                                     device=ref.device)
            exact.append(ref.vocode_i16(served))
            tf32.append(ref.vocode_i16(served, tf32=True))
            if low is not None:
                low_wav.append(low.vocode_i16(served))
            j += 1
        if not exact:
            continue
        want = np.concatenate(exact)
        u = _rel(np.concatenate(tf32), want)
        e = _rel(np.concatenate(low_wav) if low is not None else r["wav"],
                 want)
        err, unit = max(err, e), max(unit, u)
        ratio = max(ratio, e / max(u, 1e-12))
    return {"code_gap": gap, "mel_err": mel_err, "wav_err": err,
            "wav_ratio": ratio, "wav_unit": unit, "tokens": tokens,
            "compared": tokens, "calls": len(idx)}


def call_columns(r: Dict[str, Any]) -> str:
    return (f"{len(r.get('frames') or [])} {r.get('steps', 0)} "
            f"{r.get('gpt_gen', 0.0):.4f} {r.get('s2m', 0.0):.4f} "
            f"{r.get('bigvgan', 0.0):.4f}")


def compared_line(read: Dict[str, Any]) -> str:
    return (f"compared calls {read['calls']} served codes "
            f"{read['tokens']} wav_unit {read['wav_unit']}")
