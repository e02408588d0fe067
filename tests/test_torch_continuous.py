"""Continuous batching (index_tts_dubbing_tpu_torch/engine/continuous.py)
against the JAX package's engine/continuous.py and against the port's own
``decode.generate``, on the CPU in float32, greedy:

- JAX tests/test_continuous.py's two cases (5 requests on 2 slots, so slots
  refill; 2 requests on 1 slot), row for row token-exact against JAX's
  ContinuousBatcher and against ``generate`` per row;
- per-request ``max_new`` caps: the slots refill at different steps, and a
  row is ``generate``'s row cut at its cap;
- the host-driven ``insert`` and ``decode_chunk`` against JAX's;
- ``IndexTTS.infer_batch(continuous=True)`` on both engines, with an empty
  text (decoded as the row [2]): the continuous decode's codes equal, the
  int16 wav of every text within 2 LSB.

The GPT config is JAX's tests/test_continuous.py's: 70 mel codes, so random
weights emit the stop token and rows finish at different steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.engine import continuous as jcb
from index_tts_dubbing_tpu.engine import decode as jdecode
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.engine import continuous as pcb
from index_tts_dubbing_tpu_torch.engine import decode as pdecode
from tests.test_torch_engine import GREEDY, assert_i16_close, make_engines

CFG = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=24,
           max_text_tokens=40, number_text_tokens=50, number_mel_codes=70,
           start_mel_token=68, stop_mel_token=69, cond_output_size=32,
           cond_linear_units=64, cond_attention_heads=4, cond_num_blocks=1)
SC = dict(do_sample=False, max_mel_tokens=16, repetition_penalty=3.0)
BUCKETS = (8, 16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process; one torch
    thread runs these small decodes many times faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """JAX's and the port's GPT on one JAX init tree, and conditioning."""
    jcfg = jgpt.GPTConfig(**CFG)
    jparams = jax.tree.map(jnp.asarray,
                           jgpt.init(jax.random.PRNGKey(0), jcfg))
    conds = np.array(jax.random.normal(
        jax.random.PRNGKey(1), (1, jcfg.condition_num_latent, jcfg.model_dim)))
    pcfg = pconfig.GPTConfig(**CFG)
    pparams = weights.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return (jparams, jcfg, jnp.asarray(conds)), (pparams, pcfg,
                                                 torch.from_numpy(conds))


def _generate_rows(pparams, pcfg, conds, rows):
    """The port's uniform-batch ``generate``, one row at a time."""
    sc = pdecode.SamplingConfig(**SC)
    out = []
    for r in rows:
        pad_to = next((b for b in BUCKETS if b >= r.size), r.size)
        pre = pdecode.prepare_prefix_host(pcfg, [r], pad_to=pad_to)
        t = lambda k: torch.from_numpy(pre[k].astype(np.int64))
        emb, keep = pdecode.build_prefix_emb(pparams, pcfg, conds, t("ids"),
                                             t("pos"), t("seg"), t("cond_idx"))
        res = pdecode.generate(pparams, pcfg, sc, emb, keep)
        out.append((res.codes[0].numpy(), int(res.lengths[0])))
    return out


def _run_both(setup, rows, batch, max_new=None):
    (jparams, jcfg, jconds), (pparams, pcfg, pconds) = setup
    max_new = max_new or [None] * len(rows)
    jres = jcb.ContinuousBatcher(
        jparams, jcfg, jdecode.SamplingConfig(**SC), jconds, batch=batch,
        chunk=4, text_buckets=BUCKETS).run(
        [jcb.CBRequest(uid=i, text_ids=r, max_new=m)
         for i, (r, m) in enumerate(zip(rows, max_new))])
    batcher = pcb.ContinuousBatcher(
        pparams, pcfg, pdecode.SamplingConfig(**SC), pconds, batch=batch,
        text_buckets=BUCKETS)
    pres = batcher.run([pcb.CBRequest(uid=i, text_ids=r, max_new=m)
                        for i, (r, m) in enumerate(zip(rows, max_new))])
    assert set(pres) == set(jres) == set(range(len(rows)))
    for i in range(len(rows)):
        (pc, pl), (jc, jl) = pres[i], jres[i]
        assert pl == jl, f"row {i}: len {pl} != {jl}"
        np.testing.assert_array_equal(pc, np.asarray(jc))
    return pres, batcher.stats


def _assert_rows_match_generate(setup, rows, pres, max_new=None):
    _, (pparams, pcfg, pconds) = setup
    ref = _generate_rows(pparams, pcfg, pconds, rows)
    for i, (ref_codes, ref_len) in enumerate(ref):
        cap = (max_new or [None] * len(rows))[i] or SC["max_mel_tokens"]
        got_codes, got_len = pres[i]
        assert got_len == min(ref_len, cap), f"row {i}"
        np.testing.assert_array_equal(got_codes[:got_len],
                                      ref_codes[:got_len])


def test_greedy_parity_and_refill(setup):
    rng = np.random.default_rng(3)
    # 5 requests, 2 slots: at least 3 refills
    rows = [rng.integers(2, 50, size=n).astype(np.int32)
            for n in (5, 11, 7, 15, 4)]
    pres, stats = _run_both(setup, rows, batch=2)
    _assert_rows_match_generate(setup, rows, pres)
    assert stats["installs"] == 5 and stats["refills"] == 3
    assert 0.0 < stats["occupancy"] <= 1.0


def test_single_slot_serialises(setup):
    rng = np.random.default_rng(5)
    rows = [rng.integers(2, 50, size=n).astype(np.int32) for n in (6, 9)]
    pres, stats = _run_both(setup, rows, batch=1)
    _assert_rows_match_generate(setup, rows, pres)
    assert stats["refills"] == 1


def test_per_request_caps(setup):
    """Caps from 2 to the decode cap: rows finish, and their slots refill,
    at different steps; each row is generate's row cut at its cap."""
    rng = np.random.default_rng(7)
    rows = [rng.integers(2, 50, size=n).astype(np.int32)
            for n in (5, 11, 7, 15, 4, 9)]
    max_new = [3, None, 7, 16, 2, 5]
    pres, stats = _run_both(setup, rows, batch=3, max_new=max_new)
    _assert_rows_match_generate(setup, rows, pres, max_new)
    assert stats["installs"] == 6 and stats["refills"] == 3


def test_insert_and_decode_chunk_match_jax(setup):
    """The host-driven primitives: two requests prefilled alone and put into
    slots 1 and 0 of a 2-slot state by ``insert`` (one with a cap of 5),
    then ``decode_chunk``: every slot's tokens, lengths and done flags equal
    JAX's."""
    (jparams, jcfg, jconds), (pparams, pcfg, pconds) = setup
    jsc, psc = jdecode.SamplingConfig(**SC), pdecode.SamplingConfig(**SC)
    jparams = jgpt.stack_blocks(jparams)
    rng = np.random.default_rng(9)
    rows = [rng.integers(2, 50, size=n).astype(np.int32) for n in (6, 13)]
    s_total = 16 + 4 + 32 + SC["max_mel_tokens"]
    jst = jcb.init_state(jcfg, jsc, 2, s_total, jax.random.PRNGKey(0))
    pst = pcb.init_state(pcfg, psc, 2, s_total, torch.float32, "cpu")
    for slot, r, cap in ((1, rows[0], None), (0, rows[1], 5)):
        pre = pdecode.prepare_prefix_host(pcfg, [r], pad_to=16)
        t = lambda k: torch.from_numpy(pre[k].astype(np.int64))
        emb, keep = pdecode.build_prefix_emb(pparams, pcfg, pconds, t("ids"),
                                             t("pos"), t("seg"), t("cond_idx"))
        h, kv = pcb.prefill(pparams, pcfg, emb, keep)
        pcb.insert(pparams, pcfg, psc, pst, slot, h, kv, keep, max_new=cap)
        jemb, jkeep = jdecode.build_prefix_emb(
            jparams, jcfg, jconds, *(jnp.asarray(pre[k]) for k in
                                     ("ids", "pos", "seg", "cond_idx")))
        jh, jkv = jcb.prefill(jparams, jcfg, jemb, jkeep)
        jst = jcb.insert(jparams, jcfg, jsc, jst, slot, jh, jkv, jkeep,
                         None if cap is None else jnp.int32(cap))
    jst = jcb.decode_chunk(jparams, jcfg, jsc, jst, 32)
    pcb.decode_chunk(pparams, pcfg, psc, pst, 32)
    for name in ("tokens", "n_gen", "done", "pos"):
        np.testing.assert_array_equal(getattr(pst, name).numpy(),
                                      np.asarray(getattr(jst, name)), name)
    assert pst.done.all() and int(pst.n_gen[0]) <= 5


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return make_engines(tmp_path_factory.mktemp("continuous"))


def _record(monkeypatch, eng):
    """Keep each ``_decode_continuous`` call's codes and lengths."""
    out = []
    inner = eng._decode_continuous

    def wrapped(*args, **kwargs):
        codes, lens = inner(*args, **kwargs)
        out.append((np.asarray(codes), np.asarray(lens)))
        return codes, lens
    monkeypatch.setattr(eng, "_decode_continuous", wrapped)
    return out


def test_infer_batch_continuous_matches_jax(engines, monkeypatch):
    """infer_batch(continuous=True, cb_slots=2) on three texts, the middle
    one empty: every sentence row through 2 slots (the empty text as [2]); the
    codes equal, every text's int16 wav within 2 LSB, and the staged route
    (the fused route is never taken)."""
    jeng, peng, prompt = engines
    texts = ["Hello there friend. The quick brown fox jumps.", "",
             "Over the lazy dog! Once more."]
    kw = dict(GREEDY, max_mel_tokens=16, max_text_tokens_per_sentence=20,
              continuous=True, cb_slots=2)
    jrec, prec = _record(monkeypatch, jeng), _record(monkeypatch, peng)
    jouts = jeng.infer_batch(prompt, texts, **dict(kw))
    pouts = peng.infer_batch(prompt, texts, **dict(kw))
    assert jeng.last_path == peng.last_path == "staged"
    assert len(jrec) == len(prec) == 1
    (jc, jl), (pc, pl) = jrec[0], prec[0]
    n_rows = sum(max(len(peng.sentence_rows(t, 20)), 1) for t in texts)
    assert pc.shape[0] == n_rows and peng.last_cb_stats["slots"] == 2
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pc, jc)
    assert peng.last_cb_stats["refills"] == n_rows - 2
    assert len(pouts) == len(jouts) == 3
    for (psr, pwav), (jsr, jwav) in zip(pouts, jouts):
        assert psr == jsr == 24000
        assert_i16_close(pwav, jwav)
    assert pouts[1][1].shape[0] > 0          # the empty text got audio
    assert sum(w.shape[0] for _, w in pouts) \
        == peng.last_sentence_frames.sum() * 1024
