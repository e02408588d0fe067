"""Rank worker for the port's mesh and training tests
(tests/test_torch_mesh.py, tests/test_torch_mesh_engine.py,
tests/test_torch_training.py). It holds no test of its own.

Run as::

    python tests/test_torch_mesh_worker.py <task> <rank> <world> <data> \\
        <model> <init_url> <in.npz> <out.npz>

Each rank imports torch and the port only, uses one torch thread, joins a
gloo group through ``init_distributed`` at ``init_url`` (a ``file://``
store, so parallel test runs never race for a port) with a 60 s collective
timeout, builds a (data, model) mesh and runs one task on the inputs the
parent wrote (``utils.checkpoint`` layout: JAX parameter trees, inputs, a
JSON config). Rank 0 writes the task's arrays to ``out.npz``; every rank
prints ``RANK_OK <rank>`` at the end.
"""
import hashlib
import json
import os
import sys
from datetime import timedelta

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from index_tts_dubbing_tpu_torch import config as pconfig  # noqa: E402
from index_tts_dubbing_tpu_torch import weights  # noqa: E402
from index_tts_dubbing_tpu_torch.engine import decode as pdecode  # noqa: E402
from index_tts_dubbing_tpu_torch.models import gpt as pgpt  # noqa: E402
from index_tts_dubbing_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from index_tts_dubbing_tpu_torch.utils.checkpoint import (  # noqa: E402
    flatten_tree, load_params)

TASKS = {}


def task(fn):
    TASKS[fn.__name__] = fn
    return fn


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype.kind in "iu" else a)


def _cfg(z) -> pconfig.GPTConfig:
    return pconfig.GPTConfig(**json.loads(str(z["cfg"])))


def _prefix(params, cfg, z):
    pre = z["prefix"]
    return pdecode.build_prefix_emb(params, cfg, _t(z["conds"]),
                                    *(_t(pre[k]) for k in
                                      ("ids", "pos", "seg", "cond_idx")))


@task
def decode(mesh, z):
    """The trunk, greedy decode, beam search and beam sampling under the
    mesh, beside the single-process decodes."""
    cfg = _cfg(z)
    full = weights.from_jax_params(z["params"], "cpu")
    model = mesh_lib.axis_size(mesh, "model")
    specs = mesh_lib.gpt_param_specs(full, model)
    sharded = mesh_lib.shard_tree(full, specs, mesh)
    out = {}
    with mesh_lib.use(mesh):
        h = pgpt.trunk_forward(sharded, cfg,
                               mesh_lib.data_shard(mesh, _t(z["trunk_emb"])))
    out["trunk"] = mesh_lib.replicate(mesh, h)
    emb, keep = _prefix(full, cfg, z)
    sc = pdecode.SamplingConfig(do_sample=False,
                                max_mel_tokens=int(z["steps"]))
    res = pdecode.generate(sharded, cfg, sc, emb, keep, mesh=mesh)
    out["greedy_codes"], out["greedy_lens"] = res.codes, res.lengths
    res = pdecode.generate_beam(sharded, cfg, sc, emb, keep, mesh=mesh)
    out["beam_codes"], out["beam_lens"] = res.codes, res.lengths

    scs = pdecode.SamplingConfig(do_sample=True,
                                 max_mel_tokens=int(z["steps"]))
    for name, p, m in (("sample_mesh", sharded, mesh),
                       ("sample_single", full, None)):
        res = pdecode.generate_beam_sample(
            p, cfg, scs, emb, keep, torch.Generator().manual_seed(3),
            mesh=m)
        out[f"{name}_codes"] = res.codes
        res = pdecode.generate(p, cfg, scs, emb, keep,
                               torch.Generator().manual_seed(3), mesh=m)
        out[f"{name}_multinomial"] = res.codes
    out["mel_head_width"] = np.asarray(
        sharded["mel_head"]["w"].shape[-1])
    return out


@task
def multihost(mesh, z):
    """Mirrors tests/test_multihost.py: a greedy decode over a data mesh
    of two processes equals this process's own single-process decode."""
    cfg = _cfg(z)
    full = weights.from_jax_params(z["params"], "cpu")
    emb, keep = _prefix(full, cfg, z)
    sc = pdecode.SamplingConfig(do_sample=False,
                                max_mel_tokens=int(z["steps"]))
    ref = pdecode.generate(full, cfg, sc, emb, keep)
    out = pdecode.generate(full, cfg, sc, emb, keep, mesh=mesh)
    np.testing.assert_array_equal(out.codes.numpy(), ref.codes.numpy())
    print(f"MULTIHOST_OK proc={torch.distributed.get_rank()}", flush=True)
    return {"codes": out.codes}


@task
def ema(mesh, z):
    """``dvae.ema_update`` over the data group on each rank's half of the
    batch, beside the single-process update on the whole batch."""
    from index_tts_dubbing_tpu_torch.models import dvae
    logits, codes = _t(z["logits"]), _t(z["codes"])
    params = {"codebook": {"embed": _t(z["embed"])}}
    state = dvae.EMAState(_t(z["cluster"]), _t(z["embed_avg"]))
    shard = lambda x: mesh_lib.data_shard(mesh, x)
    p_mesh, s_mesh = dvae.ema_update(params, state, shard(logits),
                                     shard(codes),
                                     group=mesh.get_group("data"))
    p_one, s_one = dvae.ema_update(params, state, logits, codes)
    return {"mesh_embed": p_mesh["codebook"]["embed"],
            "mesh_cluster": s_mesh.cluster_size,
            "one_embed": p_one["codebook"]["embed"],
            "one_cluster": s_one.cluster_size}


@task
def engine(mesh, z):
    """The engine on the mesh: infer, infer_fast and infer_batch (beam
    search), infer_batch(continuous=True) with its codes recorded, and
    infer_fast with the reference's default decode (beam sampling); rank 0
    also runs the single-process engine on the staged route with the same
    seed."""
    from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS
    ecfg = json.loads(str(z["cfg"]))
    cfg = pconfig.EngineConfig(gpt=pconfig.GPTConfig(**ecfg["gpt"]),
                               bigvgan=pconfig.BigVGANConfig(**ecfg["bigvgan"]))
    prompt, texts = ecfg["prompt"], ecfg["texts"]
    kw = dict(do_sample=False, max_mel_tokens=int(z["steps"]),
              max_text_tokens_per_sentence=20)
    sample = dict(max_mel_tokens=int(z["steps"]),
                  max_text_tokens_per_sentence=20)

    def run(eng, tag):
        out = {}
        _, out[f"{tag}/infer"] = eng.infer(prompt, texts[0], None, **kw)
        _, out[f"{tag}/infer_fast"] = eng.infer_fast(prompt, texts[0], None,
                                                     **kw)
        out[f"{tag}/fast_path"] = np.asarray(eng.last_path)
        for i, (_, w) in enumerate(eng.infer_batch(prompt, texts, **kw)):
            out[f"{tag}/batch{i}"] = w
        _, out[f"{tag}/sample"] = eng.infer_fast(prompt, texts[0], None,
                                                 **sample)
        return out

    eng = IndexTTS(config=cfg, device="cpu", verbose_init=False,
                   params=z["params"], mesh=mesh)
    out = run(eng, "mesh")
    rec = []
    real = eng._decode_continuous

    def record(*a, **k):
        codes, lens = real(*a, **k)
        rec.append((codes, lens))
        return codes, lens

    eng._decode_continuous = record
    for i, (_, w) in enumerate(eng.infer_batch(
            prompt, texts, continuous=True, cb_slots=2,
            **dict(kw, num_beams=1))):
        out[f"cont/wav{i}"] = w
    out["cont/codes"], out["cont/lens"] = rec[0]
    digest = hashlib.sha1(b"".join(np.ascontiguousarray(v).tobytes()
                                   for k, v in sorted(out.items())))
    print(f"WAV_DIGEST {digest.hexdigest()}", flush=True)
    if torch.distributed.get_rank() == 0:
        single = IndexTTS(config=cfg, device="cpu", verbose_init=False,
                          params=z["params"])
        single._fused_eligible = lambda rows: False
        out.update(run(single, "single"))
    return out


@task
def train(mesh, z):
    """Two ``train_step``s on the mesh (each data group on its rows of the
    global batch) beside two on one process over the whole batch; the mesh
    parameters gathered back."""
    from index_tts_dubbing_tpu_torch.training import step as tstep
    cfg = _cfg(z)
    full = weights.from_jax_params(z["params"], "cpu")
    batch = {k: _t(v) for k, v in z["batch"].items()}
    tx = tstep.make_optimizer(lr=1e-3, warmup=1)
    one = tstep.init_state(full, tx)
    dist = tstep.init_state(full, tx, mesh)
    local = {k: mesh_lib.data_shard(mesh, v) for k, v in batch.items()}
    out = {}
    for i in range(2):
        one, m1 = tstep.train_step(one, batch, cfg, tx)
        dist, m2 = tstep.train_step(dist, local, cfg, tx)
        out[f"loss_one{i}"], out[f"loss_mesh{i}"] = m1["loss"], m2["loss"]
        out[f"norm_one{i}"], out[f"norm_mesh{i}"] = (m1["grad_norm"],
                                                     m2["grad_norm"])
    gathered = mesh_lib.unshard_tree(dist.params, dist.specs, mesh)
    for i, (a, b) in enumerate(zip(weights.jax_leaves(one.params),
                                   weights.jax_leaves(gathered))):
        out[f"one/{i}"], out[f"mesh/{i}"] = a, b
    return out


def run_ranks(name: str, tmp_path, inputs, data: int, model: int,
              timeout: float = 240.0):
    """Run task ``name`` on data × model worker processes and return rank
    0's arrays (``load_params`` layout) and every rank's output. A rank that
    fails, or outlives ``timeout``, fails the caller's test."""
    import subprocess

    from index_tts_dubbing_tpu_torch.utils.checkpoint import save_params

    world = data * model
    inp, outp = tmp_path / f"{name}_in.npz", tmp_path / f"{name}_out.npz"
    save_params(inp, inputs)
    store = tmp_path / f"{name}_store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), name, str(r), str(world),
         str(data), str(model), f"file://{store}", str(inp), str(outp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in log, (
            f"rank {r} of task {name} failed:\n{log}")
    return load_params(outp), logs


def main():
    name, rank, world, data, model, url, inp, outp = sys.argv[1:9]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    mesh_lib.init_distributed(url, world, rank, backend="gloo",
                              timeout=timedelta(seconds=60))
    mesh = mesh_lib.make_mesh(int(data), int(model), devices="cpu")
    out = TASKS[name](mesh, load_params(inp))
    if rank == 0:
        out = {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v)) for k, v in out.items()}
        np.savez(outp, **flatten_tree(out))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
