"""Training step for UnifiedVoice (text + mel cross-entropy), on one
process or on a (data, model) mesh.

Counterpart of the JAX package's ``training/step.py``, whose optimizer is
optax's ``clip_by_global_norm(1.0)`` then ``adamw`` on a
``warmup_cosine_decay_schedule(0, lr, warmup, 10_000)``. Here:

- ``torch.optim.AdamW`` (eps 1e-8, decoupled decay on every leaf, as optax
  without a mask), its learning rate set before each step to the schedule
  at the count *before* the increment, as optax reads it (step 0 runs at
  lr 0 when the warmup starts from 0);
- the clip by optax's rule: the gradients scaled by ``max / ‖g‖`` only when
  ‖g‖ exceeds ``max`` (no epsilon, unlike ``clip_grad_norm_``);
- under a mesh (parallel/mesh.py) each rank trains on its local batch: the
  gradients are averaged over ``data`` (equal local batches give the global
  batch's mean), and the global norm square-sums the tensor-parallel leaves
  over ``model`` and counts the replicated leaves once.

``save_state``/``load_state`` write and read the npz layout of the JAX
package's ``save_state``: ``params`` with the stacked trunk, ``opt_state``
as optax's flat leaves in ``jax.tree`` order (the Adam count, the first
moments, the second moments, the schedule count) and ``step``. A JAX run
resumes here and the reverse.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.config import GPTConfig
from index_tts_dubbing_tpu_torch.models import gpt as gpt_model
from index_tts_dubbing_tpu_torch.parallel import mesh as mesh_lib
from index_tts_dubbing_tpu_torch.utils.checkpoint import (load_params,
                                                          save_params)
from index_tts_dubbing_tpu_torch.weights import jax_leaves

Params = Dict[str, Any]
# the rest of JAX's optax chain, fixed there too: the schedule's length, the
# clip's norm and adamw's betas and eps
DECAY_STEPS = 10_000
MAX_NORM = 1.0
BETAS = (0.9, 0.999)
EPS = 1e-8


@dataclass(frozen=True)
class Optimizer:
    """The optimizer's settings (JAX: the optax chain)."""
    lr: float = 1e-4
    weight_decay: float = 0.01
    warmup: int = 100

    def schedule(self, count: int) -> float:
        """optax's ``warmup_cosine_decay_schedule(0, lr, warmup,
        DECAY_STEPS)`` at ``count``: linear from 0 to lr over the warmup,
        then a cosine to 0 at DECAY_STEPS."""
        if count < self.warmup:
            return self.lr * count / self.warmup
        span = DECAY_STEPS - self.warmup
        t = min(count - self.warmup, span)
        return self.lr * 0.5 * (1 + math.cos(math.pi * t / span))


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01,
                   warmup: int = 100) -> Optimizer:
    return Optimizer(lr=lr, weight_decay=weight_decay, warmup=warmup)


@dataclass
class TrainState:
    """The parameters (leaves that require grad; under a mesh this rank's
    slices), the ``torch.optim.AdamW`` over them, the step count, and the
    mesh with the parameters' specs (None on one process)."""
    params: Params
    opt_state: torch.optim.AdamW
    step: int
    mesh: Any = None
    specs: Optional[Params] = None


def init_state(params: Params, tx: Optimizer, mesh=None) -> TrainState:
    """A fresh state over a copy of ``params`` (the full GPT tree; under a
    mesh it is sharded here by ``gpt_param_specs``)."""
    specs = None
    if mesh is not None:
        specs = mesh_lib.gpt_param_specs(
            params, mesh_lib.axis_size(mesh, "model"))
        params = mesh_lib.shard_tree(params, specs, mesh)
    params = _map(lambda t: t.detach().clone().requires_grad_(True), params)
    opt = torch.optim.AdamW(jax_leaves(params), lr=0.0, betas=BETAS,
                            eps=EPS, weight_decay=tx.weight_decay)
    return TrainState(params, opt, 0, mesh, specs)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def loss_fn(params: Params, cfg: GPTConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    lt, lm = gpt_model.forward_train(
        params, cfg, batch["cond_mel"], batch["cond_lens"],
        batch["text_ids"], batch["text_lens"], batch["codes"],
        batch["code_lens"])
    return lt + lm, {"loss_text": lt, "loss_mel": lm}


def global_norm(grads: List[torch.Tensor], sharded: Optional[List[bool]],
                mesh=None) -> torch.Tensor:
    """‖g‖ over the whole model: under a mesh the tensor-parallel leaves'
    squares are summed over ``model``, the replicated leaves counted once."""
    sq = [g.float().square().sum() for g in grads]
    if mesh is None:
        return torch.stack(sq).sum().sqrt()
    zero = torch.zeros((), device=grads[0].device)
    tp_sq = sum((s for s, sh in zip(sq, sharded) if sh), zero)
    rep_sq = sum((s for s, sh in zip(sq, sharded) if not sh), zero)
    dist.all_reduce(tp_sq, group=mesh.get_group("model"))
    return (tp_sq + rep_sq).sqrt()


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               cfg: GPTConfig, tx: Optimizer
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on ``batch`` (this rank's rows under a mesh);
    updates ``state`` in place and returns it with the metrics (under a
    mesh, means over ``data``)."""
    mesh = state.mesh
    with mesh_lib.use(mesh):
        loss, metrics = loss_fn(state.params, cfg, batch)
        grads = list(torch.autograd.grad(loss, jax_leaves(state.params)))
    metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
    if mesh is not None and mesh_lib.axis_size(mesh, "data") > 1:
        d, group = mesh_lib.axis_size(mesh, "data"), mesh.get_group("data")
        for g in grads + list(metrics.values()):
            dist.all_reduce(g, group=group)
            g.div_(d)
    metrics["grad_norm"] = apply_gradients(state, grads, tx)
    return state, metrics


def apply_gradients(state: TrainState, grads: List[torch.Tensor],
                    tx: Optimizer) -> torch.Tensor:
    """The optimizer's half of a step (JAX: ``tx.update`` then
    ``apply_updates``): clip ``grads`` (leaves in ``jax_leaves`` order) by
    the global norm, set the schedule's learning rate for this step, step
    AdamW, count the step. Returns the norm before the clip."""
    sharded = (None if state.mesh is None
               else jax_leaves(mesh_lib.is_sharded(state.specs)))
    norm = global_norm(grads, sharded, state.mesh)
    if norm > MAX_NORM:
        grads = [g / norm.to(g.dtype) * MAX_NORM for g in grads]
    for p, g in zip(jax_leaves(state.params), grads):
        p.grad = g
    for group in state.opt_state.param_groups:
        group["lr"] = tx.schedule(state.step)
    state.opt_state.step()
    state.opt_state.zero_grad(set_to_none=True)
    state.step += 1
    return norm.detach()


# --- checkpointing ----------------------------------------------------------

def _moments(state: TrainState) -> Tuple[Params, Params, int]:
    """The Adam moments as trees in the parameters' structure, and the Adam
    count (zeros and 0 before the first step)."""
    opt = state.opt_state

    def get(key):
        return _map(lambda p: opt.state[p][key].detach() if p in opt.state
                    else torch.zeros_like(p.detach()), state.params)

    leaf = jax_leaves(state.params)[0]
    count = int(opt.state[leaf]["step"]) if leaf in opt.state else 0
    return get("exp_avg"), get("exp_avg_sq"), count


def save_state(path: str, state: TrainState) -> None:
    """Parameters, optimizer state and step in the JAX package's npz layout
    (under a mesh gathered over ``model`` and written by global rank 0)."""
    params = _map(lambda p: p.detach(), state.params)
    mu, nu, count = _moments(state)
    if state.mesh is not None:
        params, mu, nu = (mesh_lib.unshard_tree(t, state.specs, state.mesh)
                          for t in (params, mu, nu))
        if dist.get_rank() != 0:
            return
    opt_leaves = ([np.asarray(count, np.int32)]
                  + jax_leaves(weights.to_jax_params(mu))
                  + jax_leaves(weights.to_jax_params(nu))
                  + [np.asarray(state.step, np.int32)])
    save_params(path, {"params": weights.to_jax_params(params),
                       "opt_state": opt_leaves,
                       "step": np.asarray(state.step, np.int32)})


def load_state(path: str, tx: Optimizer, like: TrainState) -> TrainState:
    """A state from ``save_state``'s npz (the port's or the JAX package's),
    on ``like``'s device and mesh."""
    tree = load_params(path)
    dev = jax_leaves(like.params)[0].device
    full = weights.from_jax_params(tree["params"], dev)
    jax_like = weights.to_jax_params(full)
    opt = list(tree["opt_state"])
    count = int(opt[0])
    mu, rest = weights.from_jax_leaves(opt[1:], jax_like)
    nu, rest = weights.from_jax_leaves(rest, jax_like)
    mu, nu = (weights.from_jax_params(t, dev) for t in (mu, nu))
    state = init_state(full, tx, like.mesh)
    if like.mesh is not None:
        mu, nu = (mesh_lib.shard_tree(t, state.specs, like.mesh)
                  for t in (mu, nu))
    if count:
        for p, m, v in zip(jax_leaves(state.params), jax_leaves(mu),
                           jax_leaves(nu)):
            state.opt_state.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": m.to(p.dtype).clone(),
                "exp_avg_sq": v.to(p.dtype).clone()}
    state.step = int(tree["step"])
    return state
