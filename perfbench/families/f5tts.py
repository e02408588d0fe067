"""F5-TTS Base with BigVGAN-v2 ×256 on the port: the family of a
configuration with ``"family": "f5tts"``.

The program is ``F5TTS`` of ``index_tts_dubbing_tpu_torch`` on weights
this module draws from the seed, served through ``infer_batch`` (one call
a scene: every line of the mix's slot at its duration) or ``infer`` (a
one-line slot). The check runs the plain reference
(``perfbench/reference/f5tts.py``) over the compared calls:

- ``mel_err``: over the call's lines, the largest relative L2 error of the
  generated frames the program sampled (its ``last_mel``, prompt frames
  left out) against the reference's, sampled line by line from the noise
  the reference draws itself from the line's seed (``noise_seed`` of the
  call, plus the line's place in it) at the frames the reference works
  out from the line's duration. Another frame count, or a start (the
  program's ``last_noise``) other than that noise bit for bit, reads
  infinite. It covers the text encoder, the DiT, the padding masks, the
  guidance, every Euler step and the rows' seeding;
- ``wav_ratio``: the relative L2 error of the call's int16 waveform against
  the reference's exact vocoding of the program's own generated mel, line
  by line, over ``wav_unit``, the error TF32 alone makes in the reference's
  vocoder on the same mels (as IndexTTS's ``wav_ratio``). It covers the
  window plan, K1, K2, the exact patches and the emission.

``compared`` counts the generated frames read. The interface is
``perfbench/families/__init__.py``'s.
"""
from __future__ import annotations

import gc
import math
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import check, harness, traffic
from perfbench.families.indextts import fp8_weights, trace_hook
from perfbench.reference.f5tts import F5Reference
from perfbench.weights import _Draw, _leaves, _Spec, cast

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ENTRIES = ("infer", "infer_batch")
CALL_COLUMNS = "rows frames ode_s bigvgan_s"
SAMPLER = {"nfe_step", "cfg_strength", "sway_sampling_coef"}


def check_mix(mix: Dict[str, Any], path) -> None:
    if set(mix.get("decode", ())) != SAMPLER:
        raise ValueError(f"{path}: 'decode' gives F5's sampler settings, "
                         f"{sorted(SAMPLER)}")
    if mix["entry"] not in ENTRIES:
        raise ValueError(f"{path}: unknown entry {mix['entry']!r}")
    if "prompt_chars" not in mix:
        raise ValueError(f"{path}: traffic mix lacks 'prompt_chars'")
    pairs: Dict[int, float] = {}
    for s in mix["slots"]:
        if len(s.get("seconds", ())) != len(s["chars"]):
            raise ValueError(f"{path}: every slot needs one duration "
                             f"('seconds') for each text")
        for n, sec in zip(s["chars"], s["seconds"]):
            if pairs.setdefault(int(n), float(sec)) != float(sec):
                raise ValueError(f"{path}: texts of {n} tokens have two "
                                 f"durations")
    if mix["entry"] == "infer" and any(len(s["chars"]) != 1
                                       for s in mix["slots"]):
        raise ValueError(f"{path}: an 'infer' slot has one text")


def call_kwargs(mix: Dict[str, Any], slot: int) -> Dict[str, Any]:
    """The mix's sampler settings, and the slot's durations keyed by the
    token count of their text: the seed orders the texts, and each finds
    its duration by its length."""
    s = mix["slots"][slot]
    return dict(mix["decode"], seconds_by_tokens={
        int(n): float(sec) for n, sec in zip(s["chars"], s["seconds"])})


def tokens(text: str) -> int:
    """The token count the traffic generator gave a text."""
    return sum(not c.isspace() for c in text)


def ref_text(mix: Dict[str, Any], seed: int) -> str:
    """The prompt's transcript, drawn from the seed."""
    return traffic.make_text(np.random.default_rng([int(seed), 5]),
                             int(mix["prompt_chars"]))


def noise_seed(seed: int, index: int) -> int:
    """The seed of a call's noise."""
    return int(np.random.default_rng([int(seed), 6, abs(int(index))])
               .integers(2**62))


# -- weights --------------------------------------------------------------
def _dit(r: _Spec, cfg: Dict[str, Any]) -> Dict[str, Any]:
    a, df = cfg["arch"], cfg["defaults"]
    d, t, m = a["dim"], a["text_dim"], df["mel_dim"]
    inner = a["heads"] * df["dim_head"]
    k, g = df["conv_pos_kernel"], df["conv_pos_groups"]
    v = cfg["assumed"]["text_num_embeds"]["value"]
    return {
        "text": {"emb": {"w": r.normal((v + 1, t), 1.0)},
                 "blocks": [{"dw": r.conv1d(t, t, 7, groups=t),
                             "norm": r.layer_norm(t),
                             "pw1": r.linear(t, 2 * t),
                             "grn": {"gamma": r.uniform((2 * t,), 0.5),
                                     "beta": r.uniform((2 * t,), 0.5)},
                             "pw2": r.linear(2 * t, t)}
                            for _ in range(a["conv_layers"])]},
        "time": {"l1": r.linear(df["time_freq_dim"], d),
                 "l2": r.linear(d, d)},
        "input": {"proj": r.linear(2 * m + t, d),
                  "conv1": r.conv1d(d, d, k, groups=g),
                  "conv2": r.conv1d(d, d, k, groups=g)},
        "blocks": [{"mod": r.linear(d, 6 * d), "q": r.linear(d, inner),
                    "k": r.linear(d, inner), "v": r.linear(d, inner),
                    "o": r.linear(inner, d),
                    "ff1": r.linear(d, a["ff_mult"] * d),
                    "ff2": r.linear(a["ff_mult"] * d, d)}
                   for _ in range(a["depth"])],
        "final": {"mod": r.linear(d, 2 * d), "proj": r.linear(d, m)},
    }


def _vocoder(r: _Spec, b: Dict[str, Any]) -> Dict[str, Any]:
    ch0 = b["upsample_initial_channel"]
    snake = lambda ch: {"alpha": r.zeros(ch), "beta": r.zeros(ch)}
    p: Dict[str, Any] = {"conv_pre": r.conv1d(b["gpt_dim"], ch0, 7),
                         "ups": [], "resblocks": []}
    ch_in = ch0
    for i, k in enumerate(b["upsample_kernel_sizes"]):
        ch = ch0 // (2 ** (i + 1))
        p["ups"].append(r.conv_transpose1d(ch_in, ch, k))
        for kk in b["resblock_kernel_sizes"]:
            p["resblocks"].append({
                "convs1": [r.conv1d(ch, ch, kk) for _ in range(3)],
                "convs2": [r.conv1d(ch, ch, kk) for _ in range(3)],
                "acts": [snake(ch) for _ in range(6)]})
        ch_in = ch
    p["act_post"] = snake(ch_in)
    p["conv_post"] = {"w": r.conv1d(ch_in, 1, 7)["w"]}
    return p


def make_weights(cfg: Dict[str, Any], seed: int, device, dtype
                 ) -> Dict[str, Any]:
    """{"dit", "vocoder"} in the port's layout, drawn from ``seed`` on
    ``device`` as two buffers (uniform, normal) that every leaf slices: the
    DiT in ``dtype``, the vocoder in float32."""
    spec = {"dit": _dit(_Spec(), cfg),
            "vocoder": _vocoder(_Spec(), cfg["vocoder"]["bigvgan"])}
    draws: List[_Draw] = []
    _leaves(spec, draws)
    gen = torch.Generator(device).manual_seed(int(seed))
    sizes = {k: sum(math.prod(d.shape) for d in draws if d.kind == k)
             for k in ("u", "n")}
    bufs = {"u": torch.rand(sizes["u"], generator=gen, device=device),
            "n": torch.randn(sizes["n"], generator=gen, device=device)}
    offs = {"u": 0, "n": 0}

    def fill(tree, dt):
        if isinstance(tree, dict):
            return {k: fill(v, dt) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v, dt) for v in tree]
        if isinstance(tree, _Draw):
            n = math.prod(tree.shape)
            o = offs[tree.kind]
            offs[tree.kind] = o + n
            x = bufs[tree.kind][o: o + n].view(tree.shape)
            x = ((x * 2.0 - 1.0) * tree.scale if tree.kind == "u"
                 else x * tree.scale)
            return x.to(dt)
        kind, val = tree
        fn = torch.ones if kind == "ones" else torch.zeros
        return fn(val, device=device, dtype=dt)

    out = {"dit": fill(spec["dit"], dtype),
           "vocoder": fill(spec["vocoder"], torch.float32)}
    del bufs
    return out


def f5_config(cfg: Dict[str, Any]):
    """The port's ``F5Config`` of a configuration file."""
    from index_tts_dubbing_tpu_torch.config import (DiTConfig, F5Config,
                                                    MelConfig,
                                                    MelVocoderConfig)
    a, df = cfg["arch"], cfg["defaults"]
    b = dict(cfg["vocoder"]["bigvgan"])
    for key in ("upsample_rates", "upsample_kernel_sizes",
                "resblock_kernel_sizes"):
        b[key] = tuple(b[key])
    b["resblock_dilation_sizes"] = tuple(tuple(d) for d in
                                         b["resblock_dilation_sizes"])
    return F5Config(
        dit=DiTConfig(
            dim=a["dim"], depth=a["depth"], heads=a["heads"],
            dim_head=df["dim_head"], ff_mult=a["ff_mult"],
            text_dim=a["text_dim"], conv_layers=a["conv_layers"],
            text_mask_padding=a["text_mask_padding"],
            pe_attn_head=a["pe_attn_head"], mel_dim=df["mel_dim"],
            text_num_embeds=cfg["assumed"]["text_num_embeds"]["value"],
            conv_pos_kernel=df["conv_pos_kernel"],
            conv_pos_groups=df["conv_pos_groups"],
            time_freq_dim=df["time_freq_dim"],
            text_max_pos=df["text_max_pos"]),
        vocoder=MelVocoderConfig(**b), mel=MelConfig(**cfg["mel"]),
        target_rms=cfg["sampler"]["target_rms"])


class Program:
    """The system under test: the port's F5 engine on the benchmark's
    weights and prompt."""

    def __init__(self, cell, seed: int, device, workdir: Path):
        from index_tts_dubbing_tpu_torch.engine.f5 import F5TTS
        cfg = cell.config
        self.cell, self.seed = cell, int(seed)
        self.dtype = cfg["dtype"]
        params = make_weights(cfg, seed, device, DTYPES[self.dtype])
        self.tts = F5TTS(config=f5_config(cfg), params=params,
                         is_fp16=self.dtype == "bfloat16", device=device,
                         seed=int(seed),
                         vocoder_window=cfg["vocoder"]["window"],
                         verbose_init=False)
        del params
        sr = cfg["mel"]["sample_rate"]
        self.prompt = workdir / "prompt.wav"
        harness.write_prompt(self.prompt,
                             traffic.prompt_wav(cell.mix, seed, sr), sr)
        self.ref_text = ref_text(cell.mix, seed)
        self.cuda = torch.device(device).type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def serve(self, call: traffic.Call) -> Dict[str, Any]:
        tts = self.tts
        rec: Dict[str, Any] = {"index": call.index, "slot": call.slot,
                               "cap": call.cap, "texts": call.texts,
                               "error": None}
        kw = dict(call.kwargs)
        by_tokens = kw.pop("seconds_by_tokens")
        seconds = [by_tokens[tokens(t)] for t in call.texts]
        rec["t0"] = time.perf_counter()
        try:
            if self.cell.mix["entry"] == "infer":
                outs = [tts.infer(str(self.prompt), self.ref_text,
                                  call.texts[0], seconds[0],
                                  seed=noise_seed(self.seed, call.index),
                                  **kw)]
            else:
                outs = tts.infer_batch(str(self.prompt), self.ref_text,
                                       call.texts, seconds,
                                       seed=noise_seed(self.seed,
                                                       call.index), **kw)
        except Exception as e:                     # counted, not fatal
            rec["t1"] = time.perf_counter()
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["audio_s"] = 0.0
            return rec
        rec["t1"] = time.perf_counter()
        lt = tts.last_times
        rec.update(audio_s=lt.audio_seconds, ode=lt.ode, bigvgan=lt.bigvgan,
                   nfe=lt.nfe, seconds=seconds,
                   wav=np.concatenate([w[:, 0] for _, w in outs]),
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
        return F5Reference(fp8_weights(params32), cfg, torch.bfloat16)
    if kind == "bfloat16":
        return F5Reference(cast(params32, torch.bfloat16), cfg,
                           torch.bfloat16)
    raise ValueError(f"unknown control {kind!r}")


def _rel(got, want) -> float:
    return check.rel_err(np.asarray(got), np.asarray(want))


def compare(records, idx, cfg, mix, seed: int, prompt, device,
            as_control: bool = False) -> Dict[str, Any]:
    """``mel_err`` and ``wav_ratio`` (module docstring) of the float32
    reference on the seed's weights; with ``as_control`` the control's."""
    params = cast(make_weights(cfg, seed, device, DTYPES[cfg["dtype"]]),
                  torch.float32)
    ref = F5Reference(params, cfg)
    ref.set_prompt(prompt)
    low = None
    if as_control:
        low = control(params, cfg)
        low.set_prompt(prompt)
    text0 = ref_text(mix, seed)
    mel_err, err, ratio, unit, frames = 0.0, 0.0, 0.0, 0.0, 0
    tp = ref.cond.shape[0]
    for i in idx:
        r = records[i]
        if len(r["frames"]) != len(r["texts"]):
            mel_err = err = ratio = float("inf")
            continue
        by_tokens = call_kwargs(mix, r["slot"])["seconds_by_tokens"]
        first = noise_seed(seed, r["index"])
        exact, tf32, low_wav = [], [], []
        for j, text in enumerate(r["texts"]):
            n = tp + ref.frames(by_tokens[tokens(text)])
            if r["frames"][j] != n or r["prompt_frames"] != tp:
                mel_err = float("inf")
                continue
            noise = ref.noise(first + j, n)
            if not torch.equal(torch.as_tensor(r["noise"][j, :n]).cpu(),
                               noise.cpu()):
                mel_err = float("inf")
                continue
            got = np.asarray(r["mel"][j, tp:n], np.float64)
            ids = ref.text_ids(text0, text)
            mel = ref.sample(ids, n, noise, mix["decode"])
            lmel = (low.sample(ids, n, noise, mix["decode"])
                    if low is not None else None)
            mel_err = max(mel_err, _rel(
                lmel[tp:].cpu().numpy() if lmel is not None else got,
                mel[tp:].cpu().numpy()))
            frames += n - tp
            served = torch.as_tensor(got, dtype=torch.float32,
                                     device=ref.device)
            exact.append(ref.vocode_i16(served))
            tf32.append(ref.vocode_i16(served, tf32=True))
            if low is not None:
                low_wav.append(low.vocode_i16(served))
        if not exact:
            continue
        want = np.concatenate(exact)
        u = _rel(np.concatenate(tf32), want)
        e = _rel(np.concatenate(low_wav) if low is not None else r["wav"],
                 want)
        err, unit = max(err, e), max(unit, u)
        ratio = max(ratio, e / max(u, 1e-12))
    return {"mel_err": mel_err, "wav_err": err, "wav_ratio": ratio,
            "wav_unit": unit, "compared": frames, "calls": len(idx)}


def call_columns(r: Dict[str, Any]) -> str:
    frames = r.get("frames") or [0]
    return (f"{2 * len(frames)} {max(frames)} {r.get('ode', 0.0):.4f} "
            f"{r.get('bigvgan', 0.0):.4f}")


def compared_line(read: Dict[str, Any]) -> str:
    return (f"compared calls {read['calls']} generated frames "
            f"{read['compared']} wav_unit {read['wav_unit']}")
