"""The port's mesh (parallel/mesh.py) against the JAX package's, mirroring
tests/test_parallel.py and tests/test_multihost.py.

The sharding rules need no ranks: ``gpt_param_specs`` equals JAX's leaf by
leaf at model 1, 2 and 4, on float32 and int8 trees. Everything else runs
in gloo worker processes (tests/test_torch_mesh_worker.py) on the CPU: a
(data=2, model=2) mesh of four ranks for the tensor-parallel trunk (within
2e-5 of JAX's unsharded trunk), greedy decode and beam search (token-exact
against JAX), beam sampling and multinomial sampling (equal to the port's
single-process decode with the same seed) and the vocabulary-sharded mel
head; two ranks for a data-parallel decode
through ``init_distributed`` and for ``dvae.ema_update`` over the data
group."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.engine import decode as jdecode
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu.models.gpt import GPTConfig
from index_tts_dubbing_tpu.parallel import mesh as jmesh
from index_tts_dubbing_tpu.utils import quant as jquant
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.parallel import mesh as pmesh
from index_tts_dubbing_tpu_torch.utils import quant as pquant
from tests.test_torch_mesh_worker import run_ranks

SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=40,
             max_text_tokens=30, number_text_tokens=80, cond_output_size=32,
             cond_linear_units=64, cond_attention_heads=4, cond_num_blocks=2)
STEPS = 12


@pytest.fixture(scope="module")
def small():
    cfg = GPTConfig(**SMALL)
    return cfg, jgpt.init(jax.random.PRNGKey(0), cfg)


def _unstacked(params):
    n = len(jax.tree.leaves(params["blocks"])[0])
    return dict(params, blocks=[jax.tree.map(lambda x: x[i], params["blocks"])
                                for i in range(n)])


def _as_tuple(spec, ndim):
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


@pytest.mark.parametrize("tree", ["float32", "int8"])
@pytest.mark.parametrize("model", [1, 2, 4])
def test_specs_match_jax(small, model, tree):
    """Every leaf's spec equals JAX's PartitionSpec (padded with None to
    the leaf's rank); mel_head (8194) shards at model 1 and 2, not 4;
    text_head (81) at no model above 1."""
    _, params = small
    jparams = _unstacked(params)
    if tree == "int8":
        jparams = _unstacked(jquant.quantize_gpt_int8(params))
    pparams = weights.from_jax_params(params, "cpu")
    if tree == "int8":
        pparams = pquant.quantize_gpt_int8(pparams)
    jspecs = jmesh.gpt_param_specs(jparams, model_size=model)
    pspecs = pmesh.gpt_param_specs(pparams, model)
    jl, jdef = jax.tree.flatten(jspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    pl = jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(x, tuple))
    leaves = weights.jax_leaves(pparams)
    assert len(jl) == len(pl) == len(leaves)
    for j, p, x in zip(jl, pl, leaves):
        assert _as_tuple(j, x.dim()) == p
    w = "w_q" if tree == "int8" else "w"
    assert pspecs["mel_head"][w] == ((None, "model") if model in (1, 2)
                                     else (None, None))
    if model > 1:
        assert pspecs["text_head"]["w"] == (None, None)


@pytest.fixture(scope="module")
def decoded(small, tmp_path_factory):
    """JAX's unsharded results and the four ranks' (data=2, model=2)."""
    cfg, params = small
    rng = np.random.default_rng(0)
    trunk_emb = rng.standard_normal((2, 24, 64)).astype(np.float32)
    rows = [rng.integers(2, 80, size=n).astype(np.int32) for n in (5, 7, 6, 4)]
    conds = rng.standard_normal((1, cfg.condition_num_latent, cfg.model_dim)
                                ).astype(np.float32)
    pre = jdecode.prepare_prefix_host(cfg, rows, pad_to=8)
    emb, keep = jdecode.build_prefix_emb(params, cfg, jnp.asarray(conds),
                                         pre["ids"], pre["pos"], pre["seg"],
                                         pre["cond_idx"])
    sc = jdecode.SamplingConfig(do_sample=False, max_mel_tokens=STEPS)
    ref = {"trunk": np.asarray(jgpt.trunk_forward(params, cfg, trunk_emb)),
           "greedy": jdecode.generate(params, cfg, sc, emb, keep,
                                      jax.random.PRNGKey(0)),
           "beam": jdecode._beam_decode(params, cfg, sc, emb, keep,
                                        jax.random.PRNGKey(3), 3, 0.0, False)}
    inputs = {"params": jax.tree.map(np.asarray, params),
              "cfg": np.asarray(json.dumps(SMALL)), "steps": STEPS,
              "trunk_emb": trunk_emb, "conds": conds,
              "prefix": {k: pre[k] for k in ("ids", "pos", "seg", "cond_idx")}}
    out, _ = run_ranks("decode", tmp_path_factory.mktemp("decode"), inputs,
                       data=2, model=2)
    return ref, out


def test_tp_trunk_forward_matches_jax(decoded):
    ref, out = decoded
    np.testing.assert_allclose(out["trunk"], ref["trunk"], atol=2e-5)


def test_greedy_generate_token_exact(decoded):
    """Greedy decode equals JAX's through the mel head sharded over
    ``model`` (half the vocabulary on each rank)."""
    ref, out = decoded
    assert int(out["mel_head_width"]) == 8194 // 2
    np.testing.assert_array_equal(out["greedy_codes"],
                                  np.asarray(ref["greedy"].codes))
    np.testing.assert_array_equal(out["greedy_lens"],
                                  np.asarray(ref["greedy"].lengths))


def test_beam_search_token_exact(decoded):
    ref, out = decoded
    np.testing.assert_array_equal(out["beam_codes"],
                                  np.asarray(ref["beam"].codes))
    np.testing.assert_array_equal(out["beam_lens"],
                                  np.asarray(ref["beam"].lengths))


@pytest.mark.parametrize("decode", ["codes", "multinomial"])
def test_sampling_equals_single_process(decoded, decode):
    """Beam sampling (Gumbel noise drawn for the global batch) and plain
    sampling (multinomial over the gathered batch) on the mesh equal the
    single-process decode under the same seed."""
    _, out = decoded
    np.testing.assert_array_equal(out[f"sample_mesh_{decode}"],
                                  out[f"sample_single_{decode}"])


def test_two_process_distributed_decode(small, tmp_path):
    """Mirrors tests/test_multihost.py: two processes through
    ``init_distributed`` decode over a (data=2) mesh, each equal to its own
    single-process decode."""
    cfg, params = small
    rng = np.random.default_rng(7)
    rows = [rng.integers(2, 80, size=n).astype(np.int32) for n in (5, 7, 6, 4)]
    conds = rng.standard_normal((1, cfg.condition_num_latent, cfg.model_dim)
                                ).astype(np.float32)
    pre = jdecode.prepare_prefix_host(cfg, rows, pad_to=8)
    inputs = {"params": jax.tree.map(np.asarray, params),
              "cfg": np.asarray(json.dumps(SMALL)), "steps": STEPS,
              "conds": conds,
              "prefix": {k: pre[k] for k in ("ids", "pos", "seg", "cond_idx")}}
    _, logs = run_ranks("multihost", tmp_path, inputs, data=2, model=1)
    for r, log in enumerate(logs):
        assert f"MULTIHOST_OK proc={r}" in log, log
        assert ">> torch.distributed: backend gloo" in log, log


def test_ema_update_over_a_group(tmp_path):
    """``ema_update(group=)`` on each rank's half equals the one-process
    update on the whole batch (JAX: ``axis_name`` under shard_map)."""
    rng = np.random.default_rng(3)
    d, n = 16, 32
    inputs = {"logits": rng.standard_normal((4, 6, d)).astype(np.float32),
              "codes": rng.integers(0, n, size=(4, 6)).astype(np.int64),
              "embed": rng.standard_normal((d, n)).astype(np.float32),
              "cluster": rng.random(n).astype(np.float32),
              "embed_avg": rng.standard_normal((d, n)).astype(np.float32)}
    out, _ = run_ranks("ema", tmp_path, inputs, data=2, model=1)
    np.testing.assert_allclose(out["mesh_cluster"], out["one_cluster"],
                               rtol=1e-6)
    np.testing.assert_allclose(out["mesh_embed"], out["one_embed"],
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(out["one_cluster"], inputs["cluster"])


class _FakeMesh:
    """Answers ``axis_size`` only: enough for ``use`` and ``model_size``."""
    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return (3, 2)[dim]


def test_use_is_per_thread_and_restored():
    """``with use(mesh):`` is the current mesh for this thread only (as
    JAX's ``with mesh:``), nests, and is undone when the block ends, even
    by an exception; without one every collective is the identity."""
    import threading

    x = torch.ones(3)
    assert pmesh.model_size() == 1 and pmesh.copy_to_model(x) is x
    seen = []
    with pmesh.use(_FakeMesh()):
        assert pmesh.model_size() == 2
        t = threading.Thread(target=lambda: seen.append(pmesh.model_size()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with pmesh.use(None):
            assert pmesh.model_size() == 1
            assert pmesh.reduce_from_model(x) is x
            assert pmesh.gather_from_model(x) is x
        assert pmesh.model_size() == 2
        with pytest.raises(ValueError):
            with pmesh.use(None):
                raise ValueError("unwinds")
        assert pmesh.model_size() == 2
    assert seen == [1] and pmesh.model_size() == 1
