"""The port's eval package held against the JAX package's on the cases of
tests/test_eval.py: ``normalize_for_wer``, ``edit_distance`` and ``wer``
equal, and ``speaker_similarity`` through ``make_ecapa_embedder`` on the
port's ECAPA and mel front end within 1e-5 of JAX's (the same numpy ECAPA
weights, float32 on the CPU), one of the pair resampled from 16 kHz."""
import importlib

import jax
import numpy as np
import pytest

from index_tts_dubbing_tpu.eval import speaker_sim as jsim
from index_tts_dubbing_tpu.models import ecapa as jecapa
from index_tts_dubbing_tpu.ops.mel import MelSpectrogram as JMel
from index_tts_dubbing_tpu_torch import eval as peval
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.eval import speaker_sim as psim
from index_tts_dubbing_tpu_torch.ops.mel import MelSpectrogram as PMel

# the packages bind ``wer`` to the function, over the module's name
jwer = importlib.import_module("index_tts_dubbing_tpu.eval.wer")
pwer = importlib.import_module("index_tts_dubbing_tpu_torch.eval.wer")
# tests/test_eval.py:9-31
TEXTS = ["Hello, World!", "你好world", "大家好，我是Alice。", "  ", ""]
SEQS = [([], []), (list("abc"), list("abc")), (list("abc"), list("axc")),
        (list("abc"), list("ab")), (list("abc"), list("xabc")),
        (list("kitten"), list("sitting"))]
PAIRS = [("hello world", "hello world"), ("hello world", "hello word"),
         ("你好世界", "你好市界"), ("", ""), ("", "x y")]


def test_package_exports_what_jax_exports():
    assert peval.wer is pwer.wer
    assert peval.normalize_for_wer is pwer.normalize_for_wer
    assert peval.speaker_similarity is psim.speaker_similarity


@pytest.mark.parametrize("text", TEXTS)
def test_normalize_for_wer_matches_jax(text):
    assert pwer.normalize_for_wer(text) == jwer.normalize_for_wer(text)


@pytest.mark.parametrize("a,b", SEQS)
def test_edit_distance_matches_jax(a, b):
    assert pwer.edit_distance(a, b) == jwer.edit_distance(a, b)


@pytest.mark.parametrize("ref,hyp", PAIRS)
def test_wer_matches_jax(ref, hyp):
    assert pwer.wer(ref, hyp) == jwer.wer(ref, hyp)


def test_speaker_similarity_matches_jax():
    """tests/test_eval.py:34-58's three signals; a second of the second one
    also given as 16 kHz audio, so both embedders resample it."""
    jp = jax.tree.map(np.array, jecapa.init(jax.random.PRNGKey(0),
                                            input_size=100, lin_neurons=64))
    p = weights.from_jax_params(jp, device="cpu")
    jembed = jsim.make_ecapa_embedder(jp, JMel())
    pembed = psim.make_ecapa_embedder(p, PMel(device="cpu"))
    rng = np.random.default_rng(0)
    tt = np.arange(24000) / 24000.0
    a1 = (np.sin(2 * np.pi * 220 * tt)
          + 0.05 * rng.standard_normal(tt.size)).astype(np.float32)
    a2 = (np.sin(2 * np.pi * 220 * tt + 1.0)
          + 0.05 * rng.standard_normal(tt.size)).astype(np.float32)
    b = (np.sign(np.sin(2 * np.pi * 700 * tt))
         + 0.05 * rng.standard_normal(tt.size)).astype(np.float32)
    a2_16k = a2[:16000]
    for wa, sra, wb, srb in ((a1, 24000, a2, 24000), (a1, 24000, b, 24000),
                             (a1, 24000, a2_16k, 16000)):
        ref = jsim.speaker_similarity(wa, sra, wb, srb, jembed)
        got = psim.speaker_similarity(wa, sra, wb, srb, pembed)
        assert isinstance(got, float) and -1.0 <= got <= 1.0
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(pembed(b, 24000), jembed(b, 24000), atol=1e-5,
                               rtol=0)
    same = psim.speaker_similarity(a1, 24000, a2, 24000, pembed)
    diff = psim.speaker_similarity(a1, 24000, b, 24000, pembed)
    assert same > diff
