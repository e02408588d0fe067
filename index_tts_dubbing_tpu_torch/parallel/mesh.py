"""Device meshes and Megatron tensor parallelism over torch.distributed.

Counterpart of the JAX package's ``parallel/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of shape (data, model) with
the axis names of the JAX mesh:

- ``data``  — the batch axis: each data group decodes its contiguous rows
  (``data_shard``) and the rows are gathered back (``replicate``);
- ``model`` — the tensor-parallel axis: each rank holds ``heads / model``
  attention heads and a ``1 / model`` slice of every MLP, and the GPT trunk
  sums its partial products over the axis.

Where XLA inserts the collectives from sharding annotations, the port calls
them itself, as Megatron-LM does: ``copy_to_model`` before the
column-parallel linears (identity forward, all-reduce backward),
``reduce_from_model`` after the row-parallel ones (all-reduce forward,
identity backward) and ``gather_from_model`` after a vocabulary-sharded
head. They act on the mesh made current by ``with use(mesh):``, the
counterpart of JAX's ``with mesh:`` (and, like it, held per thread), so the
trunk functions keep their signatures; with no mesh current, each
collective is the identity and launches nothing.

``gpt_param_specs`` gives each leaf a tuple with one entry per dimension,
an axis name or None, by the JAX package's rules; ``shard_tree`` cuts this
rank's slice of every leaf by it. The fused qkv projection's output is the
three blocks [q | k | v]; each block is sharded by heads.
"""
from __future__ import annotations

import contextlib
import os
import threading
from datetime import timedelta
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

Params = Dict[str, Any]
Spec = Tuple[Optional[str], ...]
AXES = ("data", "model")

_local = threading.local()       # .mesh: the mesh of ``use``, per thread


# ---------------------------------------------------------------------------
# process group and mesh
# ---------------------------------------------------------------------------

def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: Optional[timedelta] = None) -> str:
    """Join the process group; returns the backend, which it also prints.

    ``coordinator_address``: "host:port" for a TCP rendezvous, or a full
    init URL ("file://...", "tcp://..."); without one the group comes from
    the environment torchrun sets (``env://``). The backend is NCCL when
    every rank of a host has a card of its own, else gloo (on the CPU, and
    for several ranks on one card, which NCCL refuses); each rank's current
    card is ``local rank % cards``."""
    if coordinator_address is None:
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards:
        torch.cuda.set_device(local_rank % cards)
    if backend is None:
        backend = "nccl" if cards >= local_world else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)
    print(f">> torch.distributed: backend {backend}, rank {rank} of {world}"
          f"{f', card {local_rank % cards}' if cards else ', CPU'}",
          flush=True)
    return backend


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[str] = None):
    """A (data, model) DeviceMesh over the initialised world, ``data``
    defaulting to world // model. ``devices``: the device type, "cuda" (the
    default; raises when no card is visible) or "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed first")
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"{data}x{model} != {n} ranks")
    devices = devices or "cuda"
    if devices == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                           'devices="cpu" for a mesh on the CPU')
    return init_device_mesh(devices, (data, model), mesh_dim_names=AXES)


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name`` (JAX: ``mesh.shape[name]``)."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along mesh axis ``name``."""
    return mesh.get_local_rank(name)


@contextlib.contextmanager
def use(mesh) -> Iterator[None]:
    """Make ``mesh`` the one the GPT trunk's collectives act on (None: no
    tensor parallelism) until the block ends."""
    prev, _local.mesh = _current(), mesh
    try:
        yield
    finally:
        _local.mesh = prev


def _current():
    return getattr(_local, "mesh", None)


def model_size() -> int:
    """The ``model`` axis size of the current mesh; 1 without one."""
    mesh = _current()
    return 1 if mesh is None else axis_size(mesh, "model")


# ---------------------------------------------------------------------------
# Megatron's collectives over the current mesh's ``model`` axis
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return _all_gather(x, group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[..., r * ctx.width:(r + 1) * ctx.width].contiguous(), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Input of a column-parallel linear: identity forward, gradients summed
    over ``model`` backward."""
    if model_size() == 1:
        return x
    return _CopyToModel.apply(x, _current().get_group("model"))


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Output of a row-parallel linear: partial products summed over
    ``model`` forward, identity backward."""
    if model_size() == 1:
        return x
    return _ReduceFromModel.apply(x, _current().get_group("model"))


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """Logits of a vocabulary-sharded head: every rank's slice of the last
    axis concatenated forward, this rank's slice of the gradient backward."""
    if model_size() == 1:
        return x
    return _GatherFromModel.apply(x, _current().get_group("model"))


# ---------------------------------------------------------------------------
# the data axis
# ---------------------------------------------------------------------------

def data_shard(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows of a global batch (JAX:
    ``data_sharding``): the batch must divide by the ``data`` axis."""
    d, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
    if x.shape[0] % d:
        raise ValueError(f"batch {x.shape[0]} does not divide by data={d}")
    n = x.shape[0] // d
    return x[r * n:(r + 1) * n]


def replicate(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every data group's rows gathered back into the global batch (JAX:
    ``replicate`` of a data-sharded array)."""
    if axis_size(mesh, "data") == 1:
        return x
    return _all_gather(x, mesh.get_group("data"), dim=0)


def all_true(mesh, flag: torch.Tensor) -> bool:
    """Whether ``flag`` (a bool tensor) is all True on every rank of the
    mesh: one all-reduce over the whole world."""
    n = (~flag).sum().reshape(1).to(torch.int64)
    dist.all_reduce(n)
    return int(n.item()) == 0


# ---------------------------------------------------------------------------
# GPT tensor-parallel sharding rules
# ---------------------------------------------------------------------------

def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replicated(v) for v in tree]
    return (None,) * tree.dim()


def _divides(node: torch.Tensor, spec: Spec, model_size: int) -> bool:
    return all(node.shape[i] % model_size == 0
               for i, ax in enumerate(spec) if ax == "model")


def gpt_param_specs(params: Params, model_size: int = 1) -> Params:
    """Spec tree for a GPT parameter tree, Megatron-style: qkv and fc shard
    the output dimension, the attention and MLP ``proj`` the input one (their
    bias stays replicated), int8 ``w_q`` shards like ``w`` and ``scale`` with
    the output dimension; the heads shard the vocabulary where it divides by
    ``model_size``, else stay replicated (the 12001-wide text head)."""
    specs = _replicated(params)

    def maybe(node, spec):
        if _divides(node, spec, model_size):
            return spec
        return (None,) * node.dim()

    def linear_spec(lin, w_spec, b_spec):
        out_ax = w_spec[-1]
        if "w_q" in lin:
            sp = {"w_q": maybe(lin["w_q"], w_spec),
                  "scale": maybe(lin["scale"], (out_ax,))}
        else:
            sp = {"w": maybe(lin["w"], w_spec)}
        if "b" in lin:
            sp["b"] = maybe(lin["b"], b_spec)
        return sp

    for blk, sp in zip(params["blocks"], specs["blocks"]):
        sp["attn"]["qkv"] = linear_spec(blk["attn"]["qkv"], (None, "model"),
                                        ("model",))
        sp["attn"]["proj"] = linear_spec(blk["attn"]["proj"], ("model", None),
                                         (None,))
        sp["mlp"]["fc"] = linear_spec(blk["mlp"]["fc"], (None, "model"),
                                      ("model",))
        sp["mlp"]["proj"] = linear_spec(blk["mlp"]["proj"], ("model", None),
                                        (None,))
    for head in ("mel_head", "text_head"):
        specs[head] = linear_spec(params[head], (None, "model"), ("model",))
    return specs


def bigvgan_param_specs(params: Params) -> Params:
    """The vocoder is replicated on every rank."""
    return _replicated(params)


def _is_qkv(path: Tuple[str, ...]) -> bool:
    return path[-3:-1] == ("attn", "qkv")


def _slice_leaf(x: torch.Tensor, spec: Spec, rank: int, n: int,
                chunks: int) -> torch.Tensor:
    for dim, ax in enumerate(spec):
        if ax == "model":
            blocks = x.chunk(chunks, dim=dim)
            x = torch.cat([blk.chunk(n, dim=dim)[rank] for blk in blocks],
                          dim=dim)
    return x.contiguous()


def _walk(tree, specs, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, specs[k], fn, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, s, fn, path + (str(i),))
                for i, (v, s) in enumerate(zip(tree, specs))]
    return fn(tree, specs, path)


def shard_tree(tree: Params, specs: Params, mesh) -> Params:
    """This rank's slice of every leaf: a dimension marked "model" is cut
    into ``model`` contiguous parts (each of qkv's [q | k | v] blocks on its
    own); the other leaves are shared."""
    n, rank = axis_size(mesh, "model"), axis_rank(mesh, "model")

    def fn(x, spec, path):
        if "model" not in spec:
            return x
        return _slice_leaf(x, spec, rank, n, 3 if _is_qkv(path) else 1)

    return _walk(tree, specs, fn)


def unshard_tree(tree: Params, specs: Params, mesh) -> Params:
    """The inverse of ``shard_tree``: every sharded leaf gathered over
    ``model``."""
    group = mesh.get_group("model")

    def fn(x, spec, path):
        if "model" not in spec:
            return x
        dim = spec.index("model")
        chunks = 3 if _is_qkv(path) else 1
        parts = _all_gather(x, group, dim).chunk(axis_size(mesh, "model"),
                                                 dim=dim)
        return torch.cat([torch.cat([p.chunk(chunks, dim=dim)[c]
                                     for p in parts], dim=dim)
                          for c in range(chunks)], dim=dim)

    return _walk(tree, specs, fn)


def is_sharded(specs: Params) -> Params:
    """A tree of bools: whether each leaf is sharded over ``model``."""
    if isinstance(specs, dict):
        return {k: is_sharded(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [is_sharded(v) for v in specs]
    return "model" in specs
