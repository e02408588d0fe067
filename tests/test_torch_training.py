"""The port's training (training/step.py, training/vocoder_losses.py,
models/bigvgan_disc.py, ``gpt.forward_train``) against the JAX package's,
mirroring tests/test_training.py and tests/test_bigvgan_disc.py, float32
on the CPU.

- ``forward_train``'s two cross-entropies within 1e-5 relative, and every
  gradient leaf within 1e-6 of its leaf's largest |g| of ``jax.grad``'s
  (the conformer's key biases excepted: attention's softmax does not see a
  bias added to every key, so their gradient is 0 in exact arithmetic and
  both frameworks return rounding noise below 1e-9);
- the optimizer on the same gradients as optax's chain (clip engaged and
  not, the warmup's lr 0 and the cosine after it) within 1e-6;
- five ``train_step``s beside JAX's: losses within 1e-5 relative,
  parameters within 5e-5, 1% of the most that five AdamW steps at lr 1e-3
  move a parameter (Adam divides each gradient by its own running size, so
  where a gradient is near 0 the frameworks' rounding passes at full
  size);
- ``save_state``/``load_state`` round trip, and a state JAX's
  ``save_state`` wrote resumed here, its next step equal to JAX's;
- ``train_step`` on a (data=2, model=2) mesh of four gloo workers equal to
  one process (tests/test_torch_mesh_worker.py);
- the discriminators, every GAN loss and both totals within 1e-4, and the
  gradient of the generator total with respect to the generated wav
  against ``jax.grad``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from index_tts_dubbing_tpu.models import bigvgan_disc as jdisc
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu.models.gpt import GPTConfig
from index_tts_dubbing_tpu.training import step as jstep
from index_tts_dubbing_tpu.training import vocoder_losses as jvl
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.models import bigvgan_disc as pdisc
from index_tts_dubbing_tpu_torch.models import gpt as pgpt
from index_tts_dubbing_tpu_torch.training import step as pstep
from index_tts_dubbing_tpu_torch.training import vocoder_losses as pvl
from tests.test_torch_mesh_worker import run_ranks

SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=40,
             max_text_tokens=30, number_text_tokens=80, cond_output_size=32,
             cond_linear_units=64, cond_attention_heads=4, cond_num_blocks=2)
ORDER = ("cond_mel", "cond_lens", "text_ids", "text_lens", "codes",
         "code_lens")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(b, seed=0):
    rng = np.random.default_rng(seed)
    return {"cond_mel": rng.standard_normal((b, 40, 100)).astype(np.float32),
            "cond_lens": np.full((b,), 40, np.int64),
            "text_ids": rng.integers(2, 80, size=(b, 10)).astype(np.int32),
            "text_lens": rng.integers(5, 11, size=b).astype(np.int64),
            "codes": rng.integers(0, 8192, size=(b, 12)).astype(np.int32),
            "code_lens": rng.integers(4, 11, size=b).astype(np.int64)}


def _t(batch):
    return {k: torch.as_tensor(v.astype(np.int64) if v.dtype.kind == "i"
                               else v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    cfg = GPTConfig(**SMALL)
    return cfg, pconfig.GPTConfig(**SMALL), jgpt.init(jax.random.PRNGKey(0),
                                                      cfg), _batch(2)


def _leaves_np(tree):
    """A port tree's leaves in JAX's order and layout (trunk stacked)."""
    return weights.jax_leaves(weights.to_jax_params(tree))


def _paths(jtree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]


def _key_bias(path):
    return "['attn']['k']['b']" in path


def test_forward_train_matches_jax(setup):
    cfg, pcfg, params, batch = setup
    jl = jax.jit(lambda p, *a: jgpt.forward_train(p, cfg, *a))(
        params, *(batch[k] for k in ORDER))
    tb = _t(batch)
    pl = pgpt.forward_train(weights.from_jax_params(params, "cpu"), pcfg,
                            *(tb[k] for k in ORDER))
    for j, p in zip(jl, pl):
        np.testing.assert_allclose(float(p), float(j), rtol=1e-5)


def test_gradients_match_jax(setup):
    cfg, pcfg, params, batch = setup
    jg = jax.jit(jax.grad(lambda p: jstep.loss_fn(p, cfg, batch)[0]))(params)
    st = pstep.init_state(weights.from_jax_params(params, "cpu"),
                          pstep.make_optimizer())
    loss, _ = pstep.loss_fn(st.params, pcfg, _t(batch))
    pg = torch.autograd.grad(loss, weights.jax_leaves(st.params))
    tree, _ = weights.from_jax_leaves([g.detach() for g in pg], st.params)
    pl = _leaves_np(tree)
    jl = jax.tree.leaves(jg)
    assert len(pl) == len(jl)
    for path, j, p in zip(_paths(jg), jl, pl):
        j = np.asarray(j)
        if _key_bias(path):
            assert np.abs(j).max() < 1e-9 and np.abs(p).max() < 1e-9, path
            continue
        np.testing.assert_allclose(p, j, rtol=0,
                                   atol=1e-6 * np.abs(j).max(), err_msg=path)


def test_optimizer_matches_optax(setup):
    """The same gradient sequence through optax's chain and the port's
    ``apply_gradients``: steps 0-1 under the warmup (lr 0, then lr), norms
    above and below the clip, the cosine after the warmup."""
    _, _, params, _ = setup
    tx_j = jstep.make_optimizer(lr=1e-3, warmup=2)
    tx_p = pstep.make_optimizer(lr=1e-3, warmup=2)
    jp, jo = params, tx_j.init(params)
    update = jax.jit(lambda g, o, p: tx_j.update(g, o, p))
    st = pstep.init_state(weights.from_jax_params(params, "cpu"), tx_p)
    rng = np.random.default_rng(5)
    n = len(jax.tree.leaves(params))
    for scale in (5.0, 0.5, 3.0, 0.1, 0.8):        # ≈ the global norm
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * scale
                                    / np.sqrt(x.size * n)).astype(np.float32),
                         params)
        norm = float(optax.global_norm(g))
        assert (norm > 1.0) == (scale > 1.0), norm
        upd, jo = update(g, jo, jp)
        jp = optax.apply_updates(jp, upd)
        pg = [torch.as_tensor(x) for x in weights.jax_leaves(
            weights.from_jax_params(g, "cpu"))]
        pn = pstep.apply_gradients(st, pg, tx_p)
        np.testing.assert_allclose(float(pn), norm, rtol=1e-5)
    for path, j, p in zip(_paths(jp), jax.tree.leaves(jp),
                          _leaves_np(st.params)):
        np.testing.assert_allclose(p, np.asarray(j), rtol=0, atol=1e-6,
                                   err_msg=path)
    assert st.step == 5


def _jax_steps(params, cfg, batch, tx, n):
    state = jstep.init_state(params, tx)
    losses = []
    for _ in range(n):
        state, m = jstep.train_step(state, batch, cfg, tx)
        losses.append(float(m["loss"]))
    return state, losses


def test_five_steps_match_optax(setup):
    cfg, pcfg, params, batch = setup
    jstate, jlosses = _jax_steps(params, cfg, batch,
                                 jstep.make_optimizer(lr=1e-3, warmup=1), 5)
    tx = pstep.make_optimizer(lr=1e-3, warmup=1)
    st = pstep.init_state(weights.from_jax_params(params, "cpu"), tx)
    plosses, norms = [], []
    for _ in range(5):
        st, m = pstep.train_step(st, _t(batch), pcfg, tx)
        plosses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    assert all(np.isfinite(plosses)) and plosses[-1] < plosses[0]
    assert max(norms) > 1.0                       # the clip engaged
    for path, j, p in zip(_paths(jstate.params),
                          jax.tree.leaves(jstate.params),
                          _leaves_np(st.params)):
        np.testing.assert_allclose(p, np.asarray(j), rtol=0, atol=5e-5,
                                   err_msg=path)


def test_checkpoint_roundtrip(setup, tmp_path):
    cfg, pcfg, params, batch = setup
    tx = pstep.make_optimizer(lr=1e-3, warmup=1)
    st = pstep.init_state(weights.from_jax_params(params, "cpu"), tx)
    for _ in range(2):
        st, _ = pstep.train_step(st, _t(batch), pcfg, tx)
    path = tmp_path / "state.npz"
    pstep.save_state(str(path), st)
    restored = pstep.load_state(str(path), tx, st)
    assert restored.step == st.step == 2
    for a, b in zip(_leaves_np(st.params), _leaves_np(restored.params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pstep._moments(st)[:2], pstep._moments(restored)[:2]):
        for x, y in zip(_leaves_np(a), _leaves_np(b)):
            np.testing.assert_array_equal(x, y)
    st, m1 = pstep.train_step(st, _t(batch), pcfg, tx)
    restored, m2 = pstep.train_step(restored, _t(batch), pcfg, tx)
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(_leaves_np(st.params), _leaves_np(restored.params)):
        np.testing.assert_array_equal(a, b)


def test_resume_a_jax_state(setup, tmp_path):
    """JAX trains one step and saves; the port loads that npz and takes the
    next step, equal to JAX's next step."""
    cfg, pcfg, params, batch = setup
    jtx = jstep.make_optimizer(lr=1e-3, warmup=1)
    jstate, _ = _jax_steps(params, cfg, batch, jtx, 1)
    path = tmp_path / "jax_state.npz"
    jstep.save_state(str(path), jstate)
    jnext, jm = jstep.train_step(jstate, batch, cfg, jtx)
    tx = pstep.make_optimizer(lr=1e-3, warmup=1)
    like = pstep.init_state(weights.from_jax_params(params, "cpu"), tx)
    st = pstep.load_state(str(path), tx, like)
    assert st.step == 1
    st, m = pstep.train_step(st, _t(batch), pcfg, tx)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    for path_, j, p in zip(_paths(jnext.params), jax.tree.leaves(jnext.params),
                           _leaves_np(st.params)):
        np.testing.assert_allclose(p, np.asarray(j), rtol=0, atol=1e-5,
                                   err_msg=path_)
    # and back: the port's npz resumes in JAX
    back = tmp_path / "port_state.npz"
    pstep.save_state(str(back), st)
    jback = jstep.load_state(str(back), jtx, jnext)
    assert int(jback.step) == 2
    for j, p in zip(jax.tree.leaves(jback.opt_state),
                    jax.tree.leaves(jnext.opt_state)):
        assert np.asarray(j).shape == np.asarray(p).shape


def test_train_step_on_a_mesh_equals_one_process(setup, tmp_path):
    _, _, params, _ = setup
    inputs = {"params": jax.tree.map(np.asarray, params),
              "cfg": np.asarray(json.dumps(SMALL)), "batch": _batch(4, 1)}
    out, _ = run_ranks("train", tmp_path, inputs, data=2, model=2)
    for i in range(2):
        np.testing.assert_allclose(out[f"loss_mesh{i}"], out[f"loss_one{i}"],
                                   rtol=1e-5)
        np.testing.assert_allclose(out[f"norm_mesh{i}"], out[f"norm_one{i}"],
                                   rtol=1e-5)
    assert len(out["one"]) == len(out["mesh"])
    for a, b in zip(out["one"], out["mesh"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


# --- the vocoder's discriminators and losses --------------------------------

@pytest.fixture(scope="module")
def discs():
    mpd = jdisc.init_mpd(jax.random.PRNGKey(0))
    mrd = jdisc.init_mrd(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    y = (rng.standard_normal((1, 3001)) * 0.2).astype(np.float32)
    yh = (rng.standard_normal((1, 3001)) * 0.2).astype(np.float32)
    return (mpd, mrd, weights.from_jax_params(mpd, "cpu"),
            weights.from_jax_params(mrd, "cpu"), y, yh)


def _close(p, j, tol=1e-4):
    np.testing.assert_allclose(np.asarray(p.detach()), np.asarray(j),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("family", ["mpd", "mrd"])
def test_discriminators_match_jax(discs, family):
    """Scores and every feature map, real and generated, at a length no
    period divides (3001: the period-folding pad)."""
    mpd, mrd, pmpd, pmrd, y, yh = discs
    jf = jdisc.mpd_forward if family == "mpd" else jdisc.mrd_forward
    pf = pdisc.mpd_forward if family == "mpd" else pdisc.mrd_forward
    jout = jax.jit(jf)(mpd if family == "mpd" else mrd, y, yh)
    pout = pf(pmpd if family == "mpd" else pmrd, torch.as_tensor(y),
              torch.as_tensor(yh))
    for js, ps in zip(jout[:2], pout[:2]):
        for j, p in zip(js, ps):
            _close(p, j)
    for js, ps in zip(jout[2:], pout[2:]):
        for jd, pd in zip(js, ps):
            assert len(jd) == len(pd)
            for j, p in zip(jd, pd):
                assert tuple(p.shape) == tuple(j.shape)
                _close(p, j)


def test_stft_mag_matches_jax():
    rng = np.random.default_rng(4)
    wav = rng.standard_normal((2, 4000)).astype(np.float32)
    for res in pdisc.MRD_RESOLUTIONS:
        _close(pdisc.stft_mag(torch.as_tensor(wav), *res),
               jdisc._stft_mag(jnp.asarray(wav), *res), tol=2e-4)


def test_gan_losses_match_jax():
    rng = np.random.default_rng(6)
    r = [rng.standard_normal((2, 10)).astype(np.float32) for _ in range(3)]
    g = [rng.standard_normal((2, 10)).astype(np.float32) for _ in range(3)]
    tr, tg = [torch.as_tensor(x) for x in r], [torch.as_tensor(x) for x in g]
    jl, jr, jg = jdisc.discriminator_loss(r, g)
    pl, pr, pg = pdisc.discriminator_loss(tr, tg)
    _close(pl, jl, 1e-5)
    for a, b in zip(pr + pg, jr + jg):
        _close(a, b, 1e-5)
    _close(pdisc.generator_loss(tg)[0], jdisc.generator_loss(g)[0], 1e-5)
    fr = [[rng.standard_normal((2, 4, 4)).astype(np.float32)] for _ in range(2)]
    fg = [[rng.standard_normal((2, 4, 4)).astype(np.float32)] for _ in range(2)]
    _close(pdisc.feature_loss([[torch.as_tensor(a) for a in b] for b in fr],
                              [[torch.as_tensor(a) for a in b] for b in fg]),
           jdisc.feature_loss(fr, fg), 1e-5)


def test_vocoder_totals_and_gradient_match_jax(discs):
    """Both totals and their terms within 1e-4; d(generator total)/d(wav_gen)
    within 1e-4 of its largest element against ``jax.grad``."""
    mpd, mrd, pmpd, pmrd, y, yh = discs
    jbanks, pbanks = jvl.make_mel_banks(), pvl.make_mel_banks(device="cpu")
    (jt, jm), jgrad = jax.jit(jax.value_and_grad(
        lambda w: jvl.generator_total_loss(mpd, mrd, jbanks, y, w),
        has_aux=True))(jnp.asarray(yh))
    ty = torch.as_tensor(y)
    tyh = torch.as_tensor(yh).requires_grad_(True)
    pt, pm = pvl.generator_total_loss(pmpd, pmrd, pbanks, ty, tyh)
    _close(pt, jt)
    assert set(pm) == set(jm)
    for k in jm:
        _close(pm[k], jm[k])
    jd, jdm = jax.jit(jvl.discriminator_total_loss)(mpd, mrd, y, yh)
    pd, pdm = pvl.discriminator_total_loss(pmpd, pmrd, ty, tyh)
    _close(pd, jd)
    for k in jdm:
        _close(pdm[k], jdm[k])
    (pgrad,) = torch.autograd.grad(pt, tyh)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(pgrad.numpy(), jgrad, rtol=0,
                               atol=1e-4 * np.abs(jgrad).max())
    # the discriminators' loss sees the generated wav detached: with no
    # parameter requiring grad here, nothing of it requires grad
    assert tyh.requires_grad and not pd.requires_grad
