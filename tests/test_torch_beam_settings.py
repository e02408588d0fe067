"""The port's beam decode held against the JAX package's ``_beam_decode``
(its "anc" history) on the CPU, in float32, with the same weights and
numpy inputs, at the small config of tests/test_beam.py, over the settings
a user gives ``IndexTTS`` (engine/tts.py ``_sampling_config``): the beam
count, the length penalty, the repetition penalty, typical sampling, the
cap, the rows and, in beam sampling, the warpers.

Three modes: beam search; beam search with a bias on the stop code's
logit, so rows finish before the cap and the finished pool decides; beam
sampling with the port's Gumbel noise replaced by the noise the JAX decode
draws from the same key. Codes and lengths must be equal, and the port's
step count may exceed JAX's by up to 7 (its host checks "every row done"
every 8 steps).
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

# tests/test_beam.py:16-19
GPT_SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=40,
                 max_text_tokens=30, number_text_tokens=80,
                 cond_output_size=32, cond_linear_units=64,
                 cond_attention_heads=4, cond_num_blocks=2)
STEPS = 14
LP = 0.6
KEY = 7
# three rows, the middle one dead; one row (the line's shape)
ROWS = {"three": ((8, 5, 7), (True, False, True)), "one": ((8,), (True,))}
# mode → (stochastic, bias added to the stop code's logit)
MODES = {"search": (False, 0.0), "search_stops": (False, 1.0),
         "sample": (True, 0.0)}
# setting → (SamplingConfig fields, length_penalty, rows, live)
SETTINGS = {
    "lp0.6": ({}, LP, "three", None),
    "lp0": ({}, 0.0, "three", None),          # the engine's default
    "lp2": ({}, 2.0, "three", None),
    "rep1": (dict(repetition_penalty=1.0), LP, "three", None),
    "typical": (dict(typical_sampling=True, typical_mass=0.9), LP, "three",
                None),
    "one_row": ({}, LP, "one", None),
    "all_live": ({}, LP, "three", (True, True, True)),
    # done checked at steps 8 and 16, before the cap
    "cap17": (dict(max_mel_tokens=17), LP, "three", None),
}
# beam sampling alone: the warpers after the beam scores
WARPERS = {
    "temp0.7_topk0": (dict(temperature=0.7, top_k=0), LP, "three", None),
    "top_p1": (dict(top_p=1.0), LP, "three", None),
}
BEAMS = (2, 3, 4)
CASES = ([(nb, mode, s) for nb in BEAMS for mode in MODES for s in SETTINGS]
         + [(nb, "sample", s) for nb in BEAMS for s in WARPERS])
DONE_SLACK = 7


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process; one torch
    thread runs these small decodes ~20x faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_setup(stop_bias: float, lens=ROWS["three"][0], seed: int = 11):
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
    """``get(stop_bias, rows)``: the setup of one weight bias and one row
    set, made once."""
    made = {}

    def get(stop_bias: float, rows: str = "three"):
        if (stop_bias, rows) not in made:
            made[stop_bias, rows] = make_setup(stop_bias, ROWS[rows][0])
        return made[stop_bias, rows]
    return get


def jax_noise(b: int, nb: int, vocab: int, steps: int, key: int = KEY):
    """The Gumbel draws of the JAX decode of ``b`` rows of ``nb`` beams
    under ``PRNGKey(key)``: ``sub0`` of ``split(rng)`` at step 0, then each
    ``sub`` of ``key, sub = split(key)``."""
    shape = (b, nb * vocab)
    k, sub = jax.random.split(jax.random.PRNGKey(key))
    out = [np.array(jax.random.gumbel(sub, shape, jnp.float32))]
    for _ in range(steps - 1):
        k, sub = jax.random.split(k)
        out.append(np.array(jax.random.gumbel(sub, shape, jnp.float32)))
    return out


def run_port(s, sc, nb: int, lp: float, live, monkeypatch):
    """The port's decode on one setup; beam sampling draws the JAX
    decode's noise."""
    if sc.do_sample:
        draws = iter(jax_noise(len(live), nb, s["cfg"].number_mel_codes,
                               sc.max_mel_tokens))
        monkeypatch.setattr(pdecode, "_gumbel", lambda shape, generator, dev:
                            torch.from_numpy(next(draws)))
    psc = pdecode.SamplingConfig(**vars(sc))
    return pdecode._beam_decode(s["p"], s["cfg"], psc, s["emb"], s["keep"],
                                None, nb, lp, stochastic=sc.do_sample,
                                live=torch.tensor(live))


def run_jax(s, sc, nb: int, lp: float, live, reorder: str = "anc"):
    return jdecode._beam_decode(s["jp"], s["jcfg"], sc, s["jemb"], s["jkeep"],
                                jax.random.PRNGKey(KEY), nb, lp,
                                stochastic=sc.do_sample, reorder=reorder,
                                live=jnp.asarray(live))


def assert_same(jres, pres, live, what: str) -> None:
    np.testing.assert_array_equal(pres.codes.numpy(), np.asarray(jres.codes),
                                  err_msg=what)
    np.testing.assert_array_equal(pres.lengths.numpy(),
                                  np.asarray(jres.lengths), err_msg=what)
    assert 0 <= pres.steps - int(jres.steps) <= DONE_SLACK, (
        what, pres.steps, int(jres.steps))
    dead = ~np.asarray(live)
    assert pres.lengths.numpy()[dead].tolist() == [0] * int(dead.sum())


@pytest.mark.parametrize("nb,mode,setting", CASES,
                         ids=[f"{nb}-{mode}-{s}" for nb, mode, s in CASES])
def test_beam_decode_matches_jax(setups, monkeypatch, nb, mode, setting):
    stochastic, bias = MODES[mode]
    fields, lp, rows, live = {**SETTINGS, **WARPERS}[setting]
    live = ROWS[rows][1] if live is None else live
    sc = jdecode.SamplingConfig(**{"do_sample": stochastic,
                                   "max_mel_tokens": STEPS, **fields})
    s = setups(bias, rows)
    jres = run_jax(s, sc, nb, lp, live)
    pres = run_port(s, sc, nb, lp, live, monkeypatch)
    assert_same(jres, pres, live, f"nb {nb} {mode} {setting}")


def test_modes_exercise_forks_and_the_pool(setups, monkeypatch):
    """The cases are not trivial: in the JAX package, skipping the history
    reorder ("none") leaves "full"'s tokens in beam search and beam
    sampling, so switches that are not the identity happen; with the stop
    bias the port's rows finish before the cap."""
    live = ROWS["three"][1]
    for mode in ("search", "sample"):
        stochastic, bias = MODES[mode]
        sc = jdecode.SamplingConfig(do_sample=stochastic, max_mel_tokens=STEPS)
        full = run_jax(setups(bias), sc, 3, LP, live, "full")
        none = run_jax(setups(bias), sc, 3, LP, live, "none")
        assert not np.array_equal(np.asarray(full.codes),
                                  np.asarray(none.codes)), mode
    sc = jdecode.SamplingConfig(do_sample=False, max_mel_tokens=STEPS)
    stops = run_port(setups(MODES["search_stops"][1]), sc, 3, LP, live,
                     monkeypatch)
    assert (stops.lengths.numpy()[np.asarray(live)] < STEPS).all(), (
        stops.lengths)


def test_anc_trunk_steps_are_looked_up_at_each_call(setups, monkeypatch):
    """The decode reads its trunk step from models/gpt.py when it calls it,
    so a wrapper set there (chip_smoke.py's trace window) sees every trunk
    step."""
    name = "trunk_decode_step_split_anc"
    calls = []
    real = getattr(pgpt, name)
    monkeypatch.setattr(pgpt, name, lambda *a, **k:
                        calls.append(1) or real(*a, **k))
    sc = jdecode.SamplingConfig(do_sample=False, max_mel_tokens=STEPS)
    res = run_port(setups(0.0), sc, 3, LP, ROWS["three"][1], monkeypatch)
    assert len(calls) == res.steps - 1, (len(calls), res.steps)
