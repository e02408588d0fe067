"""The rest of the engine against the JAX engine, part 2: the staged
infer_fast route, sequential infer, infer_batch on both routes, the
progress callback, an injected conditioning mel, and the requests the port
still refuses. The engines, tolerances and helpers are
those of tests/test_torch_engine.py (part 1)."""
import numpy as np
import pytest
import torch

from tests.test_torch_engine import (BEAM, GREEDY, SPLIT, TEXT,
                                     assert_i16_close, make_engines)

# 33 sentences of 3 tokens at max_text_tokens_per_sentence=3 (more than the
# 32 rows of the largest batch bucket); one 125-token sentence (past the
# largest text bucket, 120) at 130
MANY = " ".join(["ab."] * 33)
LONG = "x" * 125


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return make_engines(tmp_path_factory.mktemp("staged"))


def record_decodes(monkeypatch, eng):
    """Wrap ``eng._decode_batch_async`` to keep each decode's codes of its
    real rows on the host; returns the list they land in."""
    out = []
    inner = eng._decode_batch_async

    def wrapped(*args, **kwargs):
        res, n_real = inner(*args, **kwargs)
        out.append(np.asarray(res.codes)[:n_real])
        return res, n_real
    monkeypatch.setattr(eng, "_decode_batch_async", wrapped)
    return out


def _assert_same_decodes(pcodes, jcodes):
    assert len(pcodes) == len(jcodes)
    for p, j in zip(pcodes, jcodes):
        np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("text,split,n_sent", [(LONG, 130, 1), (MANY, 3, 33)])
def test_infer_fast_staged_matches_jax(engines, monkeypatch, text, split,
                                       n_sent):
    """Sentences _fused_eligible refuses (one past the largest text bucket;
    more than 32) take the staged route in both engines: every bucket's
    codes token-exact under greedy decoding, the int16 wav within I16_TOL."""
    jeng, peng, prompt = engines
    assert len(peng.sentence_rows(text, split)) == n_sent
    kw = dict(GREEDY, max_mel_tokens=16, max_text_tokens_per_sentence=split)
    jcodes = record_decodes(monkeypatch, jeng)
    pcodes = record_decodes(monkeypatch, peng)
    _, jwav = jeng.infer_fast(prompt, text, **dict(kw))
    _, pwav = peng.infer_fast(prompt, text, **dict(kw))
    assert jeng.last_path == peng.last_path == "staged"
    _assert_same_decodes(pcodes, jcodes)
    assert pwav.shape == (n_sent * 16 * 1024, 1)
    assert_i16_close(pwav, jwav)
    assert peng.last_times.decode_steps == 16 * len(pcodes)


def test_infer_fast_empty_text(engines):
    """A text with no sentence gives an empty int16 wav on the staged route.
    The JAX engine raises here (max() over the empty bucket's rows,
    engine/tts.py:477), while its infer and infer_batch return the empty
    wav: the port returns it from infer_fast too."""
    jeng, peng, prompt = engines
    sr, wav = peng.infer_fast(prompt, "", **GREEDY, max_mel_tokens=16)
    assert peng.last_path == "staged"
    assert sr == 24000 and wav.dtype == np.int16 and wav.shape == (0, 1)
    with pytest.raises(ValueError):
        jeng.infer_fast(prompt, "", **GREEDY, max_mel_tokens=16)
    for eng in (jeng, peng):
        _, wav = eng.infer(prompt, "", **GREEDY, max_mel_tokens=16)
        assert wav.dtype == np.int16 and wav.shape == (0, 1)


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_infer_matches_jax(engines, monkeypatch, decode):
    """Sequential infer, one decode per sentence: each token-exact, the
    int16 wav within I16_TOL."""
    jeng, peng, prompt = engines
    kw = dict(GREEDY if decode == "greedy" else BEAM, max_mel_tokens=16,
              max_text_tokens_per_sentence=20)
    jcodes = record_decodes(monkeypatch, jeng)
    pcodes = record_decodes(monkeypatch, peng)
    _, jwav = jeng.infer(prompt, TEXT, **dict(kw))
    _, pwav = peng.infer(prompt, TEXT, **dict(kw))
    assert len(pcodes) == 3 and all(c.shape == (1, 16) for c in pcodes)
    _assert_same_decodes(pcodes, jcodes)
    assert peng.last_path == jeng.last_path == "staged"
    assert peng.last_times.decode_steps == 3 * 16
    assert_i16_close(pwav, jwav)


def test_decode_batch_matches_jax(engines):
    """_decode_batch, one bucketed decode read back to the host: beam search
    on three rows gives JAX's codes and lengths."""
    jeng, peng, prompt = engines
    rows = peng.sentence_rows(TEXT, 20)
    out = []
    for eng in (jeng, peng):
        sc = eng._sampling_config(dict(BEAM, max_mel_tokens=16))
        out.append(eng._decode_batch(
            eng._conditioning(eng._cond_mel(prompt)), rows, sc))
    (jcodes, jlens), (pcodes, plens) = out
    assert pcodes.shape == (3, 16)
    np.testing.assert_array_equal(pcodes, np.asarray(jcodes))
    np.testing.assert_array_equal(plens, np.asarray(jlens))


@pytest.mark.parametrize("texts,split,route", [
    # every sentence non-empty and within the fused buckets
    (["Hello there friend.", "The quick brown fox jumps. Over the lazy dog!"],
     20, "fused"),
    # a text with no sentence: its one empty sentence shares a bucket with
    # the others (<= 8 sentences), and both engines decode it as the
    # one-token row [2]
    (["Hello there friend.", "", "Over the lazy dog!"], 20, "staged"),
    # more than 8 sentences: bucketing drops the empty one, and its text
    # gets an empty wav
    ([" ".join(["ab."] * 5), "", " ".join(["cd."] * 4)], 3, "staged"),
])
def test_infer_batch_matches_jax(engines, monkeypatch, texts, split, route):
    """infer_batch on both routes: the route, every decode token-exact
    (greedy), and per text the shape and the int16 wav within I16_TOL; the
    frames of each text's sentences make its length."""
    jeng, peng, prompt = engines
    kw = dict(GREEDY, max_mel_tokens=16, max_text_tokens_per_sentence=split)
    jcodes = record_decodes(monkeypatch, jeng)
    pcodes = record_decodes(monkeypatch, peng)
    jouts = jeng.infer_batch(prompt, texts, **dict(kw))
    pouts = peng.infer_batch(prompt, texts, **dict(kw))
    assert jeng.last_path == peng.last_path == route
    _assert_same_decodes(pcodes, jcodes)
    if route == "fused":
        np.testing.assert_array_equal(peng.last_fused_res.codes.numpy(),
                                      np.asarray(jeng.last_fused_res.codes))
    assert len(pouts) == len(jouts) == len(texts)
    for (psr, pwav), (jsr, jwav) in zip(pouts, jouts):
        assert psr == jsr == 24000
        assert_i16_close(pwav, jwav)
    frames = peng.last_sentence_frames
    assert sum(w.shape[0] for _, w in pouts) == frames.sum() * 1024
    empty = split == 3
    assert (pouts[1][1].shape == (0, 1)) == empty


@pytest.mark.parametrize("method", ["infer", "infer_fast"])
def test_gr_progress_matches_jax(engines, method):
    """The progress callback gets JAX's values and texts, in order, on
    infer and on both infer_fast routes (the fused one, and the staged one
    for a 125-token sentence)."""
    jeng, peng, prompt = engines
    texts = [(TEXT, 20), ("x" * 125, 130)][: 2 if method == "infer_fast" else 1]
    for text, split in texts:
        calls = {}
        for eng in (jeng, peng):
            got = calls[eng] = []
            eng.gr_progress = lambda v, desc="", got=got: got.append((v, desc))
            try:
                getattr(eng, method)(prompt, text, max_mel_tokens=16,
                                     max_text_tokens_per_sentence=split,
                                     **GREEDY)
            finally:
                eng.gr_progress = None
        assert calls[peng] == calls[jeng]
        assert calls[peng][-1] == (0.9, "save audio...")


def test_set_cond_mel_is_honoured(engines):
    """An injected conditioning mel serves requests under its key in both
    engines (no file of that name exists), with the same audio."""
    jeng, peng, prompt = engines
    mel = np.random.default_rng(5).standard_normal((1, 100, 80)).astype(
        np.float32) * 0.5
    outs = []
    for eng in (jeng, peng):
        eng.set_cond_mel(mel, key="<injected>")
        outs.append(eng.infer_fast("<injected>", TEXT, max_mel_tokens=16,
                                   **GREEDY, **SPLIT)[1])
    assert peng.cache_audio_prompt == "<injected>"
    np.testing.assert_array_equal(peng.cache_cond_mel.numpy(), mel)
    assert_i16_close(outs[1], outs[0])
    _, other = peng.infer_fast(prompt, TEXT, max_mel_tokens=16, **GREEDY,
                               **SPLIT)
    assert peng.cache_audio_prompt == prompt
    assert not np.array_equal(other, outs[1])
