"""Meshes of ranks, and how parameters and batches split over them (port
of ``nerf_texture_tpu/parallel/sharding.py``).

A ``Mesh`` is a [data, model] grid of ``torch.distributed`` ranks, each
rank one process on one device:

* **data axis**: each data rank takes its rows of the ray batch; the
  gradients are summed over the data group once a step
  (``parallel.train``);
* **model axis** (optional): the MLP weights split tensor-parallel,
  alternately by output columns and by input rows (``param_spec``), so
  that each pair of layers needs one all-reduce (``utils.mlp``'s
  Megatron operators).  The hash tables, lights, cameras and biases
  replicate.

The JAX package's ``replicated`` / ``data_sharded`` are shardings for
``jax.device_put``; here they are functions that move a tensor to the
rank's device, whole or as its rows.  Collectives use only
``all_reduce`` and ``broadcast``, the two that gloo carries for CUDA
tensors: a gather is an all-reduce of a zeroed buffer that each rank
fills at its own offset (exact: x + 0 = x), the same code on NCCL.
Outside a process group a mesh is one rank and every collective is the
identity.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class Mesh:
    """A [data, model] grid of ranks and this rank's place in it.

    ranks: [data, model] global ranks; data_index / model_index: this
    rank's row and column; data_group: the ranks of its column (same
    model index), model_group: those of its row; world_group: every
    rank of the mesh; device: where this rank's tensors live; backend:
    the process group's (None outside one)."""

    ranks: np.ndarray
    data_index: int
    model_index: int
    device: torch.device
    backend: str | None = None
    data_group: Any = None
    model_group: Any = None
    world_group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": int(self.ranks.shape[0]),
                "model": int(self.ranks.shape[1])}

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    def _group(self, axis: str):
        return {"data": self.data_group, "model": self.model_group,
                "world": self.world_group}[axis]

    def all_reduce(self, t: torch.Tensor, axis: str = "data",
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place all-reduce of ``t`` over the axis ('data', 'model' or
        'world'); returns ``t``."""
        if self.distributed:
            dist.all_reduce(t, op=op, group=self._group(axis))
        return t

    def broadcast(self, t: torch.Tensor, axis: str = "world") -> torch.Tensor:
        """In-place broadcast of ``t`` from the axis' first rank (data
        index 0 for 'data', model index 0 for 'model', the mesh's first
        rank for 'world'); returns ``t``."""
        if self.distributed:
            src = {"data": self.ranks[0, self.model_index],
                   "model": self.ranks[self.data_index, 0],
                   "world": self.ranks[0, 0]}[axis]
            dist.broadcast(t, src=int(src), group=self._group(axis))
        return t

    def gather(self, local: torch.Tensor, counts, axis: str = "data"
               ) -> torch.Tensor:
        """The rows of every rank of the axis, in rank order: ``counts``
        (host ints, one a rank) sizes each rank's share."""
        idx = self.data_index if axis == "data" else self.model_index
        start = int(sum(counts[:idx]))
        buf = local.new_zeros((int(sum(counts)),) + tuple(local.shape[1:]))
        buf[start:start + local.shape[0]] = local
        return self.all_reduce(buf, axis)

    def exclusive_scan(self, value: torch.Tensor, axis: str = "data"
                       ) -> torch.Tensor:
        """Sum of ``value`` (a 0-d tensor) over the axis' earlier ranks,
        on the device (no host sync)."""
        n = self.shape[axis]
        idx = self.data_index if axis == "data" else self.model_index
        buf = value.new_zeros((n,))
        buf[idx] = value
        self.all_reduce(buf, axis)
        return torch.sum(buf[:idx])


def mesh_layout(data: int | None, model: int, world: int) -> np.ndarray:
    """[data, model] ranks of the first data * model ranks, row-major
    (the JAX make_mesh's reshape of its device list)."""
    if data is None:
        data = world // model
    assert data * model <= world, (data, model, world)
    return np.arange(data * model).reshape(data, model)


def make_mesh(data: int | None = None, model: int = 1, *, ranks=None,
              device="cuda") -> Mesh:
    """A ('data', 'model') mesh over the process group's ranks (or the
    given ``ranks`` list, row-major), with its data and model groups.
    Every rank of the process group calls this, in the same order.
    Outside a process group: a 1 x 1 mesh of this process on ``device``.

    Args:
      data: size of the data axis (default: world size // model).
      model: size of the tensor-parallel axis.
      device: this rank's device ("cuda": the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        layout = mesh_layout(data, model, 1)
        return Mesh(ranks=layout, data_index=0, model_index=0,
                    device=device)
    world = dist.get_world_size()
    backend = dist.get_backend()
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"make_mesh: the nccl backend carries CUDA tensors "
                         f"only, not {device}")
    if ranks is None:
        layout = mesh_layout(data, model, world)
    else:
        ranks = np.asarray(ranks).reshape(-1)
        data = len(ranks) // model if data is None else data
        layout = ranks[:data * model].reshape(data, model)
    me = dist.get_rank()
    groups = {}
    # every rank creates every group, in one order
    for m in range(layout.shape[1]):
        groups[("data", m)] = dist.new_group(layout[:, m].tolist())
    for d in range(layout.shape[0]):
        groups[("model", d)] = dist.new_group(layout[d, :].tolist())
    world_group = dist.new_group(layout.reshape(-1).tolist())
    where = np.argwhere(layout == me)
    if len(where) == 0:
        raise ValueError(f"make_mesh: rank {me} is not in the mesh "
                         f"{layout.tolist()}")
    di, mi = (int(v) for v in where[0])
    return Mesh(ranks=layout, data_index=di, model_index=mi, device=device,
                backend=backend, data_group=groups[("data", mi)],
                model_group=groups[("model", di)], world_group=world_group)


def replicated(mesh: Mesh):
    """x -> x whole on the rank's device."""
    return lambda x: torch.as_tensor(x, device=mesh.device)


def data_sharded(mesh: Mesh):
    """x -> the rank's rows of x (its first axis split evenly over the
    data axis, in data-rank order) on the rank's device."""
    n = mesh.shape["data"]

    def take(x):
        x = torch.as_tensor(x, device=mesh.device)
        if x.shape[0] % n:
            raise ValueError(f"data_sharded: {x.shape[0]} rows do not split "
                             f"over {n} data ranks")
        k = x.shape[0] // n
        return x[mesh.data_index * k:(mesh.data_index + 1) * k]

    return take


# param families that replicate BY DESIGN (tables: random-access gather;
# per-frame vectors: tiny).  Substring match on any path key.
_REPLICATED_FAMILIES = ("grid", "encoder", "features_v", "phi", "cluster",
                        "camera", "gamma", "light", "table", "env")

_warned_paths: set = set()


def param_spec(path: tuple, leaf: torch.Tensor, model_size: int) -> tuple:
    """The split of one parameter over 'model', as the JAX PartitionSpec's
    entries: () replicated, (None, 'model') split by output columns,
    ('model', None) by input rows.

    MLP weights [in, out] alternate column and row splits by their layer
    index (the first integer key of ``path``), so consecutive matmuls
    contract the split dimension; a dimension that ``model_size`` does
    not divide replicates.  Hash tables, light / camera params and
    biases replicate by design; any other >= 2-D leaf of >= 4096 entries
    that falls through to replication is warned about once."""
    keys = list(path)
    if any(any(f in str(k) for f in _REPLICATED_FAMILIES) for k in keys):
        return ()
    if leaf.dim() == 2:
        layer_idx = next((k for k in keys if isinstance(k, int)), None)
        if layer_idx is not None:
            dim = 1 if layer_idx % 2 == 0 else 0     # column- then row-split
            if leaf.shape[dim] % model_size != 0:
                return ()
            return (None, "model") if dim == 1 else ("model", None)
    if leaf.dim() >= 2 and leaf.numel() >= 4096:
        key_str = "/".join(str(k) for k in keys)
        if key_str not in _warned_paths:
            _warned_paths.add(key_str)
            warnings.warn(
                f"param_spec: unrecognised param '{key_str}' "
                f"(shape {tuple(leaf.shape)}) replicates under TP; add a "
                f"rule if it should shard", stacklevel=2)
    return ()


def tree_map_with_path(fn, tree, path=()):
    """fn(path, leaf) over a nested dict / list tree of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(params, mesh: Mesh):
    """The ``param_spec`` of every leaf (all () when the model axis is
    1)."""
    m = mesh.shape["model"]
    if m == 1:
        return tree_map_with_path(lambda p, x: (), params)
    return tree_map_with_path(lambda p, x: param_spec(p, x, m), params)


def split_dim(spec: tuple) -> int | None:
    """The dimension a spec splits over 'model' (None: replicated)."""
    return next((i for i, s in enumerate(spec) if s == "model"), None)


def local_slice(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a full leaf under ``spec``."""
    dim = split_dim(spec)
    if dim is None:
        return x
    k = x.shape[dim] // mesh.shape["model"]
    return x.narrow(dim, mesh.model_index * k, k)


@dataclasses.dataclass(frozen=True, eq=False)
class TPSplit:
    """What ``utils.mlp`` reads from a split leaf: the dimension split
    over the model axis and the mesh."""

    dim: int
    mesh: Mesh


def tag(leaf: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """Mark a local leaf with its split (``leaf.tp_split``), which the
    tensor-parallel MLP apply reads; replicated leaves stay unmarked."""
    dim = split_dim(spec)
    if dim is not None:
        leaf.tp_split = TPSplit(dim, mesh)
    return leaf


def shard_params(params, mesh: Mesh):
    """Each rank's copy of a params tree: its slices of the split leaves
    (marked with their split), the replicated ones whole, all on the
    rank's device."""
    specs = param_shardings(params, mesh)

    def one(path, x):
        spec = _at(specs, path)
        t = local_slice(torch.as_tensor(x, device=mesh.device), spec, mesh)
        return tag(t.detach().clone(), spec, mesh)

    return tree_map_with_path(one, params)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree
