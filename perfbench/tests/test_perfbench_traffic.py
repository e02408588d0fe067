"""The traffic mixes: the same calls for a seed, and the stated sets of
caps and lengths for every seed."""
import collections
import json
from itertools import islice

import numpy as np
import pytest

from perfbench import traffic
from perfbench.reference import text_ids
from perfbench.tests.conftest import ROOT

LINE = traffic.load(ROOT / "perfbench" / "traffic" / "line.json")
SCENE = traffic.load(ROOT / "perfbench" / "traffic" / "scene.json")
LINE_CAPS = [35, 47, 59, 70, 82, 105, 129, 164]
SEEDS = [0, 7, 2**31 + 5, 2**33 + 1]


def _key(c):
    return (c.cap, tuple(sorted(len(t.replace(" ", ""))
                                          for t in c.texts)))


@pytest.mark.parametrize("mix", [LINE, SCENE], ids=["line", "scene"])
def test_same_calls_for_a_seed(mix):
    a = [(c.slot, c.cap, c.texts, c.kwargs)
         for c in islice(traffic.calls(mix, 2**31 + 11), 30)]
    b = [(c.slot, c.cap, c.texts, c.kwargs)
         for c in islice(traffic.calls(mix, 2**31 + 11), 30)]
    other = [(c.slot, c.cap, c.texts, c.kwargs)
             for c in islice(traffic.calls(mix, 2**31 + 12), 30)]
    assert a == b
    assert a != other


@pytest.mark.parametrize("seed", SEEDS)
def test_line_cycles_hold_the_stated_caps(seed):
    n = len(LINE["slots"])
    calls = list(islice(traffic.calls(LINE, seed), 3 * n))
    for k in range(3):
        cycle = calls[k * n:(k + 1) * n]
        assert sorted(c.cap for c in cycle) == LINE_CAPS
        assert collections.Counter(map(_key, cycle)) == collections.Counter(
            map(_key, list(islice(traffic.calls(LINE, 1), n))))
    assert np.mean(LINE_CAPS) == pytest.approx(86.375)
    # the caps are the line durations at 24000/1024 codes a second
    secs = [s["seconds"] for s in LINE["slots"]]
    assert [round(s * 24000 / 1024) for s in secs] == LINE_CAPS


@pytest.mark.parametrize("seed", SEEDS)
def test_scene_calls_are_sixteen_lines_at_164(seed):
    calls = list(islice(traffic.calls(SCENE, seed), 8))
    for c in calls:
        assert c.cap == 164 and len(c.texts) == 16
        assert sorted(len(t.replace(" ", "")) for t in c.texts) == sorted(
            [10, 13, 15, 18, 21, 26, 32, 40] * 2)


@pytest.mark.parametrize("seed", SEEDS)
def test_line_cycles_are_pairs(seed):
    """Every cycle is four short+long pairs, each about 8.5 s of audio."""
    pairs = {frozenset(p) for p in ((35, 164), (47, 129), (59, 105),
                                    (70, 82))}
    calls = list(islice(traffic.calls(LINE, seed), 24))
    for k in range(3):
        cycle = calls[8 * k: 8 * k + 8]
        got = {frozenset((a.cap, b.cap))
               for a, b in zip(cycle[0::2], cycle[1::2])}
        assert got == pairs


@pytest.mark.parametrize("mix", [LINE, SCENE], ids=["line", "scene"])
def test_decode_settings(mix):
    for c in islice(traffic.calls(mix, 3), 12):
        assert c.kwargs == dict(do_sample=True, num_beams=3, top_k=30,
                                top_p=0.8, temperature=1.0,
                                length_penalty=0.0, max_mel_tokens=c.cap)


@pytest.mark.parametrize("decode", [dict(do_sample=False, num_beams=1),
                                    dict(do_sample=True, num_beams=1),
                                    dict(do_sample=False, num_beams=3)])
def test_a_mix_the_check_cannot_read_is_refused(tmp_path, decode):
    mix = json.loads((ROOT / "perfbench" / "traffic" / "line.json"
                      ).read_text())
    mix["decode"].update(decode)
    (tmp_path / "m.json").write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="beam sampling"):
        traffic.load(tmp_path / "m.json")


def test_warmup_covers_every_slot():
    for mix in (LINE, SCENE):
        w = traffic.warmup_calls(mix, 5)
        assert sorted(c.slot for c in w) == list(range(len(mix["slots"])))


@pytest.mark.parametrize("n", [2, 10, 13, 40])
def test_texts_tokenize_to_their_length(n):
    """One sentence of n ids, in the engine's tokenizer and the
    reference's alike."""
    from index_tts_dubbing_tpu_torch.engine.tts import CharTokenizer
    from index_tts_dubbing_tpu_torch.utils.front import TextNormalizer
    tok = CharTokenizer(12000, TextNormalizer())
    rng = np.random.default_rng(n)
    for _ in range(20):
        text = traffic.make_text(rng, n)
        sents = tok.split_sentences(tok.tokenize(text), 100)
        assert len(sents) == 1
        ids = tok.convert_tokens_to_ids(sents[0])
        assert ids == text_ids(text, 12000).tolist()
        assert len(ids) == n


def test_prompt_is_fixed_length_and_seeded():
    a = traffic.prompt_wav(LINE, 4, 24000)
    assert a.shape == (72000,) and a.dtype == np.float32
    assert np.array_equal(a, traffic.prompt_wav(LINE, 4, 24000))
    assert 0.4 < np.abs(a).max() <= 0.5


def test_mix_files_name_their_keys():
    for path in (ROOT / "perfbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        assert {"entry", "slots", "decode", "prompt_seconds"} <= set(mix)
