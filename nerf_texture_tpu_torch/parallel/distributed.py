"""Multi-process start-up (port of ``nerf_texture_tpu/parallel/distributed.py``).

The JAX package calls ``jax.distributed.initialize`` once per host
process; here each process is one rank of a ``torch.distributed``
process group, started by ``torchrun`` (or any launcher that sets its
environment: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``).  With the NCCL backend each rank
drives the card ``cuda:LOCAL_RANK``; with gloo the caller places its
tensors (the CPU, or ranks that share one card).

Without a coordinator ``initialize_multihost`` is a no-op returning
False, so the entry points call it unconditionally.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

_initialized = False


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         backend: str = "nccl",
                         timeout: float = 60.0) -> bool:
    """Join this process to the process group of a multi-process launch.

    The arguments default from torchrun's environment: the coordinator is
    ``MASTER_ADDR:MASTER_PORT`` (an address with a scheme, such as
    ``file:///path``, is used as the rendezvous URL as it is), the
    process count ``WORLD_SIZE`` and the process id ``RANK``.  Without a
    coordinator, or in a world of one process, nothing is initialised and
    False is returned.  A coordinator without ``WORLD_SIZE`` or ``RANK``
    raises: a silent single-process run would quietly drop the launch.
    Idempotent (True once initialised).

    ``backend`` is used as given: with ``"nccl"`` the process drives the
    card ``cuda:LOCAL_RANK`` and raises where there is none; ``"gloo"``
    leaves the device to the caller.  ``timeout`` (seconds) bounds every
    collective, so a rank that never arrives fails the run."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = os.environ["MASTER_ADDR"]
        if "MASTER_PORT" in os.environ:
            coordinator_address += f":{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            f"initialize_multihost: a coordinator ({coordinator_address}) "
            f"without WORLD_SIZE and RANK (world size {num_processes}, "
            f"rank {process_id}); set both, as torchrun does")
    if num_processes <= 1:
        return False
    if backend == "nccl":
        local_rank = _env_int("LOCAL_RANK") or 0
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_multihost: the nccl backend needs "
                               "a CUDA card, and this process has none")
        torch.cuda.set_device(local_rank)
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))
    _initialized = True
    return True


def global_layout(model: int, world: int, local_world: int) -> np.ndarray:
    """[data, model] ranks of the global mesh: ranks host-major (torchrun
    numbers the ranks of one host consecutively), each 'model' row within
    one host.  Raises where ``model`` does not divide a host's rank
    count."""
    per_host: dict[int, list[int]] = {}
    for r in range(world):
        per_host.setdefault(r // local_world, []).append(r)
    if model > 1:
        for host, ranks in per_host.items():
            if len(ranks) % model != 0:
                raise ValueError(
                    f"model={model} does not divide host {host}'s "
                    f"{len(ranks)} ranks; tensor parallelism must stay "
                    "intra-host")
    ordered = [r for host in sorted(per_host) for r in per_host[host]]
    data = len(ordered) // model
    return np.asarray(ordered[:data * model]).reshape(data, model)


def make_global_mesh(model: int = 1, *, device="cuda"):
    """('data', 'model') mesh over every rank of the process group, host-
    major, so the 'model' axis (one all-reduce per MLP layer pair) never
    leaves a host.  A host's rank count is ``LOCAL_WORLD_SIZE`` (default:
    the whole world)."""
    from .sharding import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    layout = global_layout(model, world, local_world)
    return make_mesh(layout.shape[0], model, ranks=layout.reshape(-1),
                     device=device)
