"""Multi-rank training steps: data-parallel rays, optional tensor-parallel
MLPs, replicated hash tables (port of ``nerf_texture_tpu/parallel/
train.py``).

Under GSPMD the JAX step is the single-device step and XLA inserts the
gradient all-reduce.  Here every rank runs the single-device math on its
rows of the batch and the global semantics are rebuilt by hand:

* the loss is normalised by the global ray count, so the gradients of
  the ranks sum to the single-device gradient: one all-reduce over the
  data group a step, of one flat buffer per dtype (the loss rides in
  it), after every leaf the loss did not reach got its zero gradient (so
  that every rank reduces the same list);
* the pool keeps the single-device per-ray cap (``render_rays``'
  ``pool_rays`` = the global ray count);
* replicated state stays bitwise equal on every rank: under tensor
  parallelism the replicated leaves' reduced gradients are broadcast
  from model rank 0 (CUDA's atomics may part the ranks' copies in the
  last bits), and ``sync_grid`` broadcasts a refreshed grid from the
  mesh's first rank.

The step's random draws (the JAX step's key) are arguments, the same on
every rank: the march jitter ``u`` of the whole batch.
"""

from __future__ import annotations

import torch

from ..models import ngp
from ..ops.occupancy import OccupancyGrid
from ..render.renderer import RenderConfig, render_rays
from ..train.trainer import (TrainConfig, TrainState, apply_gradients,
                             param_leaves)
from .sharding import (Mesh, data_sharded, local_slice, param_shardings,
                       tag, tree_map_with_path)


def reduce_gradients(params, mesh: Mesh, extra: torch.Tensor | None = None):
    """Sum the params' gradients over the data group in place (a leaf
    without one gets zeros first), in one flat buffer per dtype; ``extra``
    (e.g. the rank's share of the loss) rides in the f32 buffer and is
    returned summed.  Under tensor parallelism the replicated leaves'
    sums are then broadcast from model rank 0."""
    leaves = param_leaves(params)
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    rows = [p.grad for p in leaves]
    if extra is not None:
        rows.append(extra.reshape(1).to(torch.float32))
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for g in rows:
        by_dtype.setdefault(g.dtype, []).append(g)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        mesh.all_reduce(flat, "data")
        _unflatten_into(flat, grads)
    if mesh.shape["model"] > 1:
        rep = [p.grad for p in leaves
               if getattr(p, "tp_split", None) is None]
        for dtype in {g.dtype for g in rep}:
            grads = [g for g in rep if g.dtype == dtype]
            flat = torch.cat([g.reshape(-1) for g in grads])
            mesh.broadcast(flat, "model")
            _unflatten_into(flat, grads)
    return None if extra is None else rows[-1][0]


def _unflatten_into(flat: torch.Tensor, grads: list[torch.Tensor]):
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


def dp_train_step(state: TrainState, rays_o, rays_d, gt_rgb, bg, u, *,
                  mcfg: ngp.NGPConfig, rcfg: RenderConfig,
                  tcfg: TrainConfig, mesh: Mesh) -> torch.Tensor:
    """One sharded NGP step over a prepared ray batch: each data rank
    renders its rows of rays_o / rays_d / gt_rgb [N, 3] and u [N] (the
    march jitter; the same whole batch on every rank) over the background
    ``bg``, the MSE against the whole batch's mean, one gradient
    all-reduce, Adam, EMA.  Updates ``state`` (``shard_state``'s) in
    place; returns the global loss (a device scalar)."""
    take = data_sharded(mesh)
    n_global = rays_o.shape[0]
    params = state.params
    out = render_rays(lambda x, d: ngp.forward(params, x, d, mcfg),
                      state.occ.occ, take(rays_o), take(rays_d), rcfg,
                      max_samples=rcfg.max_samples_train, perturb=True,
                      u=take(u), bg_color=bg, pool_rays=n_global)
    loss = torch.sum((out["image"] - take(gt_rgb)) ** 2) / (3 * n_global)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss = reduce_gradients(params, mesh, loss.detach())
    apply_gradients(state, tcfg)
    return loss


def _shard_leaves(tree, specs, mesh: Mesh, trainable: bool):
    def one(path, x):
        spec = specs
        for k in path:
            spec = spec[k]
        t = local_slice(x.detach().to(mesh.device), spec, mesh).clone()
        return tag(t.requires_grad_(trainable), spec, mesh)

    return tree_map_with_path(one, tree)


def _shard_optimizer(state, params, specs, mesh: Mesh):
    """A new Adam + LambdaLR over the sharded ``params`` with the old
    one's hyperparameters, learning-rate schedule position and moments
    (each moment sliced like its parameter)."""
    old, group = state.optimizer, state.optimizer.param_groups[0]
    opt = torch.optim.Adam(param_leaves(params), lr=group["initial_lr"],
                           betas=group["betas"], eps=group["eps"])
    sched = torch.optim.lr_scheduler.LambdaLR(opt,
                                              state.scheduler.lr_lambdas[0])
    sched.last_epoch = state.scheduler.last_epoch
    opt.param_groups[0]["lr"] = group["lr"]
    spec_leaves = []
    tree_map_with_path(lambda p, s: spec_leaves.append(s), specs)
    for p_old, p_new, spec in zip(param_leaves(state.params),
                                  param_leaves(params), spec_leaves):
        st = old.state.get(p_old)
        if not st:
            continue
        opt.state[p_new] = {
            k: (local_slice(v.to(mesh.device), spec, mesh).clone()
                if k != "step" else v.clone())
            for k, v in st.items()}
    return opt, sched


def _replicate_grid(occ: OccupancyGrid, mesh: Mesh) -> OccupancyGrid:
    return OccupancyGrid(*(t.to(mesh.device).clone() for t in occ))


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's copy of a TrainState on the mesh: params, Adam moments
    and EMA per ``param_shardings`` (TP-aware; split leaves carry their
    split), the occupancy grid and step replicated."""
    specs = param_shardings(state.params, mesh)
    params = _shard_leaves(state.params, specs, mesh, True)
    opt, sched = _shard_optimizer(state, params, specs, mesh)
    return TrainState(params=params, optimizer=opt, scheduler=sched,
                      ema_params=_shard_leaves(state.ema_params, specs, mesh,
                                               False),
                      occ=_replicate_grid(state.occ, mesh), step=state.step)


def shard_curved_state(state, field_state, mesh: Mesh):
    """This rank's copy of a CurvedTrainState for ``curved_train_step(
    mesh=)``: params, Adam moments and EMA follow ``param_shardings``
    (hash tables replicated, MLPs split when the model axis > 1), the
    occupancy grid and error map replicated.  ``field_state`` (the
    template geometry, read-only) is returned as it is: build it on the
    mesh's device."""
    import dataclasses

    specs = param_shardings(state.params, mesh)
    params = _shard_leaves(state.params, specs, mesh, True)
    opt, sched = _shard_optimizer(state, params, specs, mesh)
    emap = state.error_map
    return dataclasses.replace(
        state, params=params, optimizer=opt, scheduler=sched,
        ema_params=_shard_leaves(state.ema_params, specs, mesh, False),
        occ=_replicate_grid(state.occ, mesh),
        error_map=None if emap is None else emap.to(mesh.device).clone(),
    ), field_state


def sync_grid(state, mesh: Mesh):
    """Broadcast the occupancy grid from the mesh's first rank after a
    refresh, so that every rank marches the same cells (two ranks that
    refresh the same grid through CUDA's atomics may part in the last
    bits, and then in the mask)."""
    for t in state.occ:
        mesh.broadcast(t, "world")
    return state


def gathered_leaf(leaf: torch.Tensor, x: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """The whole tensor of ``x`` (default: the leaf itself; e.g. its
    gradient or an Adam moment), split like the local ``leaf``, gathered
    over the model group (a copy; replicated leaves come back as they
    are)."""
    x = (leaf if x is None else x).detach()
    tp = getattr(leaf, "tp_split", None)
    if tp is None:
        return x
    counts = [x.shape[tp.dim]] * tp.mesh.shape["model"]
    if tp.dim == 0:
        return tp.mesh.gather(x, counts, "model")
    return tp.mesh.gather(x.t().contiguous(), counts, "model").t()
