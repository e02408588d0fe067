"""Every beam history strategy of the port's ``_beam_decode`` held against
the JAX package's same strategy on the CPU, in float32, with the same
weights and numpy inputs, at the small config of tests/test_beam.py: three
rows, the middle one dead through ``live``, ``max_mel_tokens`` 14.

Three modes per strategy: beam search; beam search with a bias on the stop
code's logit, so rows finish before the cap and the finished pool decides;
beam sampling with the port's Gumbel noise replaced by the noise the JAX
decode draws from the same key. Codes and lengths must be equal, and the
port's step count may exceed JAX's by up to 7 (its host checks "every row
done" every 8 steps).

This file holds the ancestry and split families; the legacy single-buffer
family is in tests/test_torch_histories_legacy.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.engine import decode as jdecode
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.engine import decode as pdecode
from index_tts_dubbing_tpu_torch.models import gpt as pgpt
from index_tts_dubbing_tpu_torch.ops import permute

# tests/test_beam.py:16-19
GPT_SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=40,
                 max_text_tokens=30, number_text_tokens=80,
                 cond_output_size=32, cond_linear_units=64,
                 cond_attention_heads=4, cond_num_blocks=2)
NB = 3
STEPS = 14
LP = 0.6
KEY = 7
LIVE = np.array([True, False, True])
# mode → (stochastic, bias added to the stop code's logit)
MODES = {"search": (False, 0.0), "search_stops": (False, 1.0),
         "sample": (True, 0.0)}
DONE_SLACK = 7
ANC_SPLIT = ("anc", "ancb", "ancsw", "ancg", "ancfull", "ancnone", "split",
             "splitnone", "cof", "cofdense")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process; one torch
    thread runs these small decodes ~20x faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_setup(stop_bias: float, lens=(8, 5, 7), seed: int = 11):
    jcfg = jgpt.GPTConfig(**GPT_SMALL)
    jp = jax.tree.map(np.array, jgpt.init(jax.random.PRNGKey(1), jcfg))
    jp["mel_head"]["b"][jcfg.stop_mel_token] += stop_bias
    rng = np.random.default_rng(seed)
    texts = [rng.integers(2, 80, size=n).astype(np.int64) for n in lens]
    conds = rng.standard_normal((len(lens), 32, 64)).astype(np.float32)
    pre = jdecode.prepare_prefix_host(jcfg, texts)
    names = ("ids", "pos", "seg", "cond_idx")
    jemb, jkeep = jdecode.build_prefix_emb(jp, jcfg, conds,
                                           *(pre[k] for k in names))
    cfg = pconfig.GPTConfig(**GPT_SMALL)
    p = weights.from_jax_params(jp, device="cpu")
    emb, keep = pdecode.build_prefix_emb(
        p, cfg, torch.from_numpy(conds),
        *(torch.from_numpy(pre[k]).long() for k in names))
    return dict(jcfg=jcfg, jp=jp, jemb=jemb, jkeep=jkeep, cfg=cfg, p=p,
                emb=emb, keep=keep)


@pytest.fixture(scope="module")
def setups():
    return {bias: make_setup(bias) for bias in {b for _, b in MODES.values()}}


def jax_noise(b: int, vocab: int, steps: int, key: int = KEY):
    """The Gumbel draws of the JAX decode under ``PRNGKey(key)``: ``sub0``
    of ``split(rng)`` at step 0, then each ``sub`` of ``key, sub =
    split(key)``."""
    shape = (b, NB * vocab)
    k, sub = jax.random.split(jax.random.PRNGKey(key))
    out = [np.array(jax.random.gumbel(sub, shape, jnp.float32))]
    for _ in range(steps - 1):
        k, sub = jax.random.split(k)
        out.append(np.array(jax.random.gumbel(sub, shape, jnp.float32)))
    return out


def run_port(s, reorder: str, stochastic: bool, monkeypatch, steps=STEPS):
    """The port's decode of one strategy on one setup; beam sampling draws
    the JAX decode's noise."""
    if stochastic:
        draws = iter(jax_noise(len(LIVE), s["cfg"].number_mel_codes, steps))
        monkeypatch.setattr(pdecode, "_gumbel", lambda shape, generator, dev:
                            torch.from_numpy(next(draws)))
    sc = pdecode.SamplingConfig(do_sample=stochastic, max_mel_tokens=steps)
    return pdecode._beam_decode(s["p"], s["cfg"], sc, s["emb"], s["keep"],
                                None, NB, LP, stochastic=stochastic,
                                reorder=reorder, live=torch.from_numpy(LIVE))


def run_both(s, reorder: str, stochastic: bool, monkeypatch, steps=STEPS):
    """(JAX result, port result) of one strategy on one setup."""
    sc = jdecode.SamplingConfig(do_sample=stochastic, max_mel_tokens=steps)
    jres = jdecode._beam_decode(s["jp"], s["jcfg"], sc, s["jemb"], s["jkeep"],
                                jax.random.PRNGKey(KEY), NB, LP,
                                stochastic=stochastic, reorder=reorder,
                                live=jnp.asarray(LIVE))
    return jres, run_port(s, reorder, stochastic, monkeypatch, steps)


def assert_same(jres, pres, what: str) -> None:
    np.testing.assert_array_equal(pres.codes.numpy(), np.asarray(jres.codes),
                                  err_msg=what)
    np.testing.assert_array_equal(pres.lengths.numpy(),
                                  np.asarray(jres.lengths), err_msg=what)
    assert 0 <= pres.steps - int(jres.steps) <= DONE_SLACK, (
        what, pres.steps, int(jres.steps))
    assert pres.lengths.numpy()[~LIVE].tolist() == [0] * int((~LIVE).sum())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("reorder", ANC_SPLIT)
def test_history_matches_jax(setups, monkeypatch, reorder, mode):
    stochastic, bias = MODES[mode]
    jres, pres = run_both(setups[bias], reorder, stochastic, monkeypatch)
    assert_same(jres, pres, f"{reorder} {mode}")


def test_modes_exercise_forks_and_the_pool(setups, monkeypatch):
    """The cases are not trivial: without a reorder ("none") beam search
    and beam sampling leave "full"'s tokens, so switches that are not the
    identity happen; with the stop bias rows finish before the cap."""
    for mode in ("search", "sample"):
        stochastic, bias = MODES[mode]
        full = run_port(setups[bias], "full", stochastic, monkeypatch)
        none = run_port(setups[bias], "none", stochastic, monkeypatch)
        assert not torch.equal(full.codes, none.codes), mode
    stops = run_port(setups[MODES["search_stops"][1]], "full", False,
                     monkeypatch)
    assert (stops.lengths.numpy()[LIVE] < STEPS).all(), stops.lengths


def test_ancsw_takes_every_width(monkeypatch):
    """At max_mel_tokens 40 "ancsw" runs its gen products at the widths 10,
    20 and 40 (in that order, as the slot grows) and still equals JAX's
    "ancsw" and the port's "full"."""
    s = make_setup(0.0)
    assert pgpt.sw_widths(40) == (10, 20, 40)
    widths = []
    real = pgpt._split_anc_step

    def spy(*args):
        widths.append(args[-1])
        return real(*args)

    monkeypatch.setattr(pgpt, "_split_anc_step", spy)
    for stochastic in (False, True):
        widths.clear()
        jres, pres = run_both(s, "ancsw", stochastic, monkeypatch, steps=40)
        assert_same(jres, pres, f"ancsw 40 stochastic={stochastic}")
        assert sorted(set(widths)) == [10, 20, 40] and widths == sorted(widths)
        full = run_port(s, "full", stochastic, monkeypatch, steps=40)
        np.testing.assert_array_equal(pres.codes.numpy(), full.codes.numpy())


def test_cofdense_calls_copy_on_fork_once_per_step(setups, monkeypatch):
    """"cofdense" calls copy_on_fork once per selection step (bound j - 1),
    as "cof" does, through the wrapper, which on the CPU takes the plain
    version and counts no launch; no other strategy of this file calls
    it."""
    calls = {}
    real = permute.copy_on_fork

    def spy(kg, vg, cp, bound, gb=64):
        calls.setdefault(reorder, []).append(bound)
        return real(kg, vg, cp, bound, gb)

    real.launches = 0
    monkeypatch.setattr(permute, "copy_on_fork", spy)
    steps = {}
    for reorder in ANC_SPLIT:
        steps[reorder] = run_port(setups[0.0], reorder, False,
                                  monkeypatch).steps
    assert set(calls) == {"cof", "cofdense"}
    for reorder in ("cof", "cofdense"):
        assert calls[reorder] == list(range(-1, steps[reorder] - 1))
    assert real.launches == 0


def test_anc_trunk_steps_are_looked_up_at_each_call(setups, monkeypatch):
    """The decode reads each ancestry step from models/gpt.py when it calls
    it, so a wrapper set there (chip_smoke.py's trace window) sees every
    trunk step."""
    for reorder, name in (("anc", "trunk_decode_step_split_anc"),
                          ("ancb", "trunk_decode_step_split_anc_bias")):
        calls = []
        real = getattr(pgpt, name)
        monkeypatch.setattr(pgpt, name, lambda *a, _r=real, **k:
                            calls.append(1) or _r(*a, **k))
        res = run_port(setups[0.0], reorder, False, monkeypatch)
        assert len(calls) == res.steps - 1, (reorder, len(calls), res.steps)
