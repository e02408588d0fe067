"""IndexTTS (v1.5 and v1.0) on the port: the family of a configuration
without ``"family"``.

The program is ``IndexTTS`` of ``index_tts_dubbing_tpu_torch`` on the
benchmark's weights (``perfbench/weights.py``), served through
``infer_fast`` or ``infer_batch`` by beam sampling; the check reads the
served codes and waveform against the plain reference
(``perfbench/reference/``, ``perfbench/check.py``). The interface is
``perfbench/families/__init__.py``'s.
"""
from __future__ import annotations

import contextlib
import gc
import os
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import check, harness, traffic, weights
from perfbench.reference import Reference

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ENTRIES = ("infer_fast", "infer_batch")
CALL_COLUMNS = "steps gpt_gen_s bigvgan_s"


def check_mix(mix: Dict[str, Any], path) -> None:
    if "decode" not in mix:
        raise ValueError(f"{path}: traffic mix lacks 'decode'")
    if mix["entry"] not in ENTRIES:
        raise ValueError(f"{path}: unknown entry {mix['entry']!r}")
    d = mix["decode"]
    if not (d.get("do_sample") and d.get("num_beams", 1) > 1):
        raise ValueError(f"{path}: the check reads beam sampling only "
                         f"(do_sample and num_beams > 1)")


def call_kwargs(mix: Dict[str, Any], slot: int) -> Dict[str, Any]:
    return dict(mix["decode"], max_mel_tokens=int(mix["slots"][slot]["cap"]))


def engine_config(config: Dict[str, Any]):
    from index_tts_dubbing_tpu_torch.config import (BigVGANConfig,
                                                    EngineConfig, GPTConfig,
                                                    MelConfig)
    b = dict(config["bigvgan"])
    for key in ("upsample_rates", "upsample_kernel_sizes",
                "resblock_kernel_sizes"):
        b[key] = tuple(b[key])
    b["resblock_dilation_sizes"] = tuple(tuple(d) for d in
                                         b["resblock_dilation_sizes"])
    return EngineConfig(mel=MelConfig(**config["mel"]),
                        gpt=GPTConfig(**config["gpt"]),
                        bigvgan=BigVGANConfig(**b),
                        version=config["version"])


class Program:
    """The system under test: the port's engine on the benchmark's weights
    and prompt."""

    def __init__(self, cell, seed: int, device, workdir: Path):
        from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS
        cfg = cell.config
        self.cell = cell
        self.dtype = cfg["dtype"]
        params = weights.make(cfg, seed, device, DTYPES[self.dtype])
        self.tts = IndexTTS(config=engine_config(cfg), params=params,
                            is_fp16=self.dtype == "bfloat16", device=device,
                            seed=int(seed), verbose_init=False)
        sr = cfg["mel"]["sample_rate"]
        self.prompt = workdir / "prompt.wav"
        harness.write_prompt(self.prompt,
                             traffic.prompt_wav(cell.mix, seed, sr), sr)
        self.cuda = torch.device(device).type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def serve(self, call: traffic.Call) -> Dict[str, Any]:
        tts, entry = self.tts, self.cell.mix["entry"]
        rec: Dict[str, Any] = {"index": call.index, "slot": call.slot,
                               "cap": call.cap,
                               "texts": call.texts, "error": None}
        rec["t0"] = time.perf_counter()
        try:
            with open(os.devnull, "w") as sink, \
                    contextlib.redirect_stdout(sink):
                if entry == "infer_fast":
                    _, wav = tts.infer_fast(str(self.prompt), call.texts[0],
                                            **call.kwargs)
                    wav = wav[:, 0]
                else:
                    outs = tts.infer_batch(str(self.prompt), call.texts,
                                           **call.kwargs)
                    wav = np.concatenate([w[:, 0] for _, w in outs])
        except Exception as e:                     # counted, not fatal
            rec["t1"] = time.perf_counter()
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["audio_s"] = 0.0
            return rec
        rec["t1"] = time.perf_counter()
        lt = tts.last_times
        res = tts.last_fused_res if tts.last_path == "fused" else None
        rec.update(audio_s=lt.audio_seconds, gpt_gen=lt.gpt_gen,
                   bigvgan=lt.bigvgan, steps=lt.decode_steps,
                   beams=tts._num_beams, wav=wav, path=tts.last_path,
                   frames=[int(f) for f in tts.last_sentence_frames],
                   codes=None if res is None else res.codes[:len(call.texts)])
        return rec

    def free(self) -> None:
        del self.tts
        gc.collect()
        torch.cuda.empty_cache()


def fp8_weights(tree):
    """Every matrix (ndim >= 2) rounded to float8 e4m3 with a per-tensor
    scale (amax to 448), back in bfloat16; vectors in bfloat16."""
    if isinstance(tree, dict):
        return {k: fp8_weights(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fp8_weights(v) for v in tree]
    if not tree.is_floating_point():
        return tree
    x = tree.float()
    if x.dim() < 2:
        return x.to(torch.bfloat16)
    scale = x.abs().max().clamp_min(1e-30) / 448.0
    q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(torch.bfloat16)


def control(params32, cfg):
    """The control: the reference one precision below the
    configuration's."""
    kind = cfg["control"]
    if kind == "fp8_weights_bf16":
        return Reference(fp8_weights(params32), cfg, torch.bfloat16)
    if kind == "bfloat16":
        return Reference(weights.cast(params32, torch.bfloat16), cfg,
                         torch.bfloat16)
    raise ValueError(f"unknown control {kind!r}")


def compare(records, idx, cfg, mix, seed: int, prompt, device,
            as_control: bool = False) -> Dict[str, Any]:
    """``check.readings`` of the float32 reference on the seed's weights;
    ``compared`` is the served codes read."""
    params = weights.cast(weights.make(cfg, seed, device,
                                       DTYPES[cfg["dtype"]]), torch.float32)
    ref = Reference(params, cfg, torch.float32)
    ref.set_prompt(prompt)
    low = None
    if as_control:
        low = control(params, cfg)
        low.set_prompt(prompt)
    read = check.readings(ref, records, idx, cfg, mix["decode"], seed,
                          low=low)
    read["compared"] = read["tokens"]
    return read


@contextlib.contextmanager
def trace_hook():
    """K2's launch shapes, recorded from the benchmark's side: the engine's
    vocoder calls ``resblock_cmajor`` by the name it imported."""
    from index_tts_dubbing_tpu_torch.engine import vocoder as voc_mod
    launches: List[tuple] = []
    orig = voc_mod.resblock_cmajor

    def recording(x, *args, **kwargs):
        k = args[5] if len(args) > 5 else kwargs["k"]
        launches.append((x.shape[0], x.shape[1], x.shape[2], int(k),
                         "bfloat16" if x.dtype == torch.bfloat16
                         else "float32"))
        return orig(x, *args, **kwargs)

    voc_mod.resblock_cmajor = recording
    try:
        yield launches
    finally:
        voc_mod.resblock_cmajor = orig


def call_columns(r: Dict[str, Any]) -> str:
    return (f"{r.get('steps', 0)} {r.get('gpt_gen', 0.0):.4f} "
            f"{r.get('bigvgan', 0.0):.4f}")


def compared_line(read: Dict[str, Any]) -> str:
    return (f"compared calls {read['calls']} served codes "
            f"{read['tokens']} wav_unit {read['wav_unit']}")
