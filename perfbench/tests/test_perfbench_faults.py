"""The check on a run whose timed path is broken underneath: each fault a
served cell can have makes ``correct`` false. The look for a chip is
skipped and the rest of a run is driven on the CPU at the tests' small
size. The exchange between chips has no fault here: every cell runs on
one chip and serves no mesh."""
import numpy as np
import pytest

from index_tts_dubbing_tpu_torch.engine import decode as decode_mod
from index_tts_dubbing_tpu_torch.engine import fused as fused_mod
from index_tts_dubbing_tpu_torch.engine import tts as tts_mod
from index_tts_dubbing_tpu_torch.models import gpt as gpt_model
from perfbench.tests.conftest import run_tiny


def _state_unchanged(monkeypatch):
    """Every cached decode step returns the state it was given."""
    names = [n for n in dir(gpt_model) if n.startswith("trunk_decode_step")]
    for n in names:
        monkeypatch.setattr(gpt_model, n,
                            lambda params, cfg, x, *a, **k: x)


def _half_batch(monkeypatch):
    """The second half of a batched call's lines comes back empty."""
    orig = tts_mod.IndexTTS.infer_batch

    def infer_batch(self, prompt, texts, **kw):
        outs = orig(self, prompt, texts, **kw)
        half = len(outs) // 2
        return outs[:half] + [(sr, w[:0]) for sr, w in outs[half:]]
    monkeypatch.setattr(tts_mod.IndexTTS, "infer_batch", infer_batch)


def _token_altered(monkeypatch):
    """One code of every row altered where the decode produces it."""
    def altered(fn):
        def wrapped(*a, **k):
            res = fn(*a, **k)
            codes = res.codes.clone()
            codes[:, 3] = (codes[:, 3] + 1) % 8192
            return res._replace(codes=codes)
        return wrapped
    monkeypatch.setattr(decode_mod, "generate", altered(decode_mod.generate))
    monkeypatch.setattr(decode_mod, "_beam_decode",
                        altered(decode_mod._beam_decode))


def _answer_altered(monkeypatch):
    """A stretch of the int16 answer zeroed where it is emitted: on the
    device by the static window plan, or on the host for a stream that is
    vocoded again at its own length."""
    orig = fused_mod.vocode_fused
    orig_i16 = tts_mod._to_i16

    def vocode(*a, **k):
        res = orig(*a, **k)
        w = res.wav_i16.clone()
        w[100:400] = 0
        return res._replace(wav_i16=w)

    def to_i16(wav):
        w = orig_i16(wav).copy()
        w[100:400] = 0
        return w
    monkeypatch.setattr(fused_mod, "vocode_fused", vocode)
    monkeypatch.setattr(tts_mod, "_to_i16", to_i16)


def test_sound_run_is_correct(tiny_root):
    assert run_tiny(tiny_root, "scene.tiny")[0]["correct"] is True


@pytest.mark.parametrize("fault,workload", [
    (_state_unchanged, "line.tiny"),
    (_half_batch, "scene.tiny"),
    (_token_altered, "line.tiny"),
    (_token_altered, "scene.tiny"),
    (_answer_altered, "line.tiny"),
    (_answer_altered, "scene.tiny"),
], ids=["state-unchanged", "half-batch", "token-line", "token-scene",
        "answer-line", "answer-scene"])
def test_fault_makes_correct_false(tiny_root, monkeypatch, fault, workload):
    fault(monkeypatch)
    r, lines = run_tiny(tiny_root, workload)
    assert r["correct"] is False, lines
    assert any(not np.isfinite(c["value"]) or c["value"] > c["limit"]
               for c in r["checks"].values()), lines
