"""Training and rendering of the Instant-NGP stage (port of
``nerf_texture_tpu/train/trainer.py``).

One training step:

  frame + pixel draws -> ray gen -> occupancy march (jittered) ->
  compacted sample pool -> field (AMP table read) -> composite -> MSE ->
  backward -> Adam (+ LambdaLR decay) -> EMA of the parameters

and every ``grid_update_interval`` steps a density-grid refresh.  With
``NGPConfig.bg_radius`` > 0 the learned background sphere
(``ngp.background`` at ``polar_from_ray``) takes the drawn background's
place in the render -- the target keeps the drawn one, as in the JAX
package -- and a frame's rays that composite no weight show its image
(``ngp_background_image``).
Checkpoints (``save_checkpoint`` and the rotating, best and resume
helpers below) are directories holding one ``torch.save`` file of the
state in the JAX state's layout.  The
random draws of a step (frame, pixel indices, march jitter, background)
come from ``sample_batch`` and those of a refresh from
``occupancy.grid_draws``, both on one ``torch.Generator``, so that a test
can hand the port the draws the JAX package made.

PyTorch idiom in place of the JAX one: the state is mutable (the
optimizer updates the parameters in place, the EMA is updated in place),
``torch.optim.Adam`` with a ``LambdaLR`` stands in for optax, and no
activation checkpointing is used (``jax.checkpoint`` was a TPU memory
measure; the pool's activations fit the card).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, NamedTuple

import numpy as np
import torch

from ..data.rays import get_rays, sample_ray_indices
from ..models import ngp
from ..ops import occupancy as occ_mod
from ..ops.hashgrid_packed import inference_table
from ..ops.marching import polar_from_ray
from ..ops.occupancy import OccupancyGrid
from ..render.renderer import (PrepassState, RenderConfig, render_image,
                               render_rays)
from ..utils.metrics import psnr
from ..utils.misc import MetricsLogger


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Every field of the JAX TrainConfig; see the JAX module for what
    each one does."""

    lr: float = 1e-2
    lr_final_ratio: float = 0.1   # LambdaLR lr_final_ratio ** (t / T)
    total_steps: int = 40000
    num_rays: int = 4096
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    adam_eps: float = 1e-15
    ema_decay: float = 0.95
    grid_update_interval: int = 16
    grid_full_updates: int = 2 ** 30
    grid_decay: float = 0.95
    random_bg: bool = True
    error_map: bool = False


@dataclasses.dataclass
class TrainState:
    """Mutable training state; every tensor on one device."""

    params: dict[str, Any]
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    ema_params: dict[str, Any]
    occ: OccupancyGrid
    step: int = 0


class Batch(NamedTuple):
    """The random draws of one training step."""

    frame: torch.Tensor   # [] int64 training frame
    inds: torch.Tensor    # [num_rays] int64 pixel indices
    u: torch.Tensor       # [num_rays] f32 march jitter in [0, 1)
    bg: torch.Tensor      # [3] f32 background colour


def param_leaves(params) -> list[torch.Tensor]:
    """The parameter tensors of a params tree, in a fixed order."""
    if isinstance(params, dict):
        return [t for k in params for t in param_leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in param_leaves(v)]
    return [params]


def _map_params(fn, params):
    if isinstance(params, dict):
        return {k: _map_params(fn, v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_map_params(fn, v) for v in params)
    return fn(params)


def make_optimizer(params, tcfg: TrainConfig):
    """Adam(betas=(b1, b2), eps) over the params tree, and a LambdaLR of
    lr_final_ratio ** (min(step, T) / T) stepped once per update."""
    opt = torch.optim.Adam(param_leaves(params), lr=tcfg.lr,
                           betas=(tcfg.adam_b1, tcfg.adam_b2),
                           eps=tcfg.adam_eps)
    T = tcfg.total_steps
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: tcfg.lr_final_ratio ** (min(step, T) / T))
    return opt, sched


def init_train_state(generator: torch.Generator, mcfg: ngp.NGPConfig,
                     rcfg: RenderConfig, tcfg: TrainConfig,
                     params=None) -> TrainState:
    """Fresh state on the generator's device: seeded params (or the given
    ones, e.g. converted from JAX), zero Adam moments, the EMA equal to
    the params, an empty occupancy grid."""
    if params is None:
        params = ngp.init(generator, mcfg)
    params = _map_params(lambda t: t.detach().clone().requires_grad_(True),
                         params)
    opt, sched = make_optimizer(params, tcfg)
    return TrainState(
        params=params, optimizer=opt, scheduler=sched,
        ema_params=_map_params(lambda t: t.detach().clone(), params),
        occ=occ_mod.create(rcfg.grid_size, rcfg.cascades,
                           device=params["grid"].device))


def sample_batch(generator: torch.Generator, *, num_frames: int, H: int,
                 W: int, tcfg: TrainConfig) -> Batch:
    """A training step's draws, on the generator's device: a frame, the
    pixel indices, the march jitter and the background (random, or white
    without ``random_bg``)."""
    dev = generator.device
    frame = torch.randint(0, num_frames, (), generator=generator,
                          device=dev)
    inds, _ = sample_ray_indices(generator, H, W, tcfg.num_rays)
    u = torch.rand((tcfg.num_rays,), generator=generator, device=dev)
    bg = (torch.rand((3,), generator=generator, device=dev)
          if tcfg.random_bg else torch.ones((3,), device=dev))
    return Batch(frame=frame, inds=inds, u=u, bg=bg)


def train_loss(params, occ: OccupancyGrid, batch: Batch, poses, images,
               intrinsics, *, mcfg: ngp.NGPConfig, rcfg: RenderConfig,
               H: int, W: int):
    """(MSE loss [], render output) of one batch; differentiable in
    params.  poses [B, 4, 4], images [B, H, W, C] uint8, intrinsics [4],
    all on the params' device."""
    rays = get_rays(poses[batch.frame], intrinsics, H, W, batch.inds)
    image = images[batch.frame]
    pixels = image.reshape(H * W, -1)[batch.inds].to(torch.float32) / 255.0
    if pixels.shape[-1] == 4:
        bg = batch.bg
        gt_rgb = pixels[:, :3] * pixels[:, 3:] + bg * (1.0 - pixels[:, 3:])
    else:
        bg = torch.ones((3,), device=pixels.device)
        gt_rgb = pixels[:, :3]
    if mcfg.bg_radius > 0:
        # the learned background sphere takes the drawn colour's place in
        # the render (not in gt_rgb) and trains through the (1 - w_sum) *
        # bg term (nerf/renderer.py:353-356, network.py:145-160)
        polar = polar_from_ray(rays["rays_o"], rays["rays_d"],
                               mcfg.bg_radius)
        bg = ngp.background(params, polar, rays["rays_d"], mcfg)
    out = render_rays(lambda x, d: ngp.forward(params, x, d, mcfg), occ.occ,
                      rays["rays_o"], rays["rays_d"], rcfg,
                      max_samples=rcfg.max_samples_train, perturb=True,
                      u=batch.u, bg_color=bg)
    return torch.mean((out["image"] - gt_rgb) ** 2), out


def apply_gradients(state, tcfg: TrainConfig):
    """The update after a backward, of a ``TrainState`` or a curved
    ``CurvedTrainState``: Adam on the params' ``.grad``, one step of the
    LR decay, the EMA of the new params; ``state.step`` + 1.  A leaf the
    loss did not reach gets a zero gradient, so that, as in optax, its
    moments decay and its step count stays the others' (torch's Adam
    would skip it)."""
    for p in param_leaves(state.params):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.scheduler.step()
    with torch.no_grad():
        ema = param_leaves(state.ema_params)
        torch._foreach_mul_(ema, tcfg.ema_decay)
        torch._foreach_add_(ema, [p.detach() for p in
                                  param_leaves(state.params)],
                            alpha=1.0 - tcfg.ema_decay)
    state.step += 1


def train_step(state: TrainState, batch: Batch, poses, images, intrinsics,
               *, mcfg: ngp.NGPConfig, rcfg: RenderConfig,
               tcfg: TrainConfig, H: int, W: int) -> dict[str, torch.Tensor]:
    """One iteration on ``batch``: loss, backward, ``apply_gradients``.
    Updates ``state`` in place; returns device scalars (no host sync)."""
    loss, out = train_loss(state.params, state.occ, batch, poses, images,
                           intrinsics, mcfg=mcfg, rcfg=rcfg, H=H, W=W)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    apply_gradients(state, tcfg)
    return {"loss": loss.detach(),
            "mean_samples": torch.mean(out["counts"].to(torch.float32))}


def grid_step(state: TrainState, draws, *, mcfg: ngp.NGPConfig,
              rcfg: RenderConfig, full: bool, decay: float = 0.95):
    """Density-grid EMA refresh with the draws of
    ``occupancy.grid_draws``; replaces ``state.occ``."""

    def density_fn(pts):
        return ngp.density(state.params, pts, mcfg)[0]

    state.occ = occ_mod.update(
        state.occ, density_fn, draws, grid_size=rcfg.grid_size,
        cascades=rcfg.cascades, bound=rcfg.bound,
        density_thresh=rcfg.density_thresh,
        density_scale=rcfg.density_scale, full=full, decay=decay)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _infer_table_dtype(mcfg: ngp.NGPConfig):
    return (torch.bfloat16 if mcfg.encoder == "packed"
            and mcfg.infer_table_bf16 else None)


def ngp_field_apply(params, x, d, mcfg: ngp.NGPConfig):
    """Field fn for rendering: (sigma, rgb) through the inference table."""
    return ngp.forward(params, x, d, mcfg,
                       table_dtype=_infer_table_dtype(mcfg))


def ngp_sigma_apply(params, x, d, mcfg: ngp.NGPConfig):
    """Sigma pass: (sigma, geo_feat), geo_feat kept for the color pass."""
    return ngp.density(params, x, mcfg, table_dtype=_infer_table_dtype(mcfg))


def ngp_color_apply(params, x, d, geo_feat, mcfg: ngp.NGPConfig):
    return ngp.color(params, d, geo_feat, mcfg)


def ngp_deferred_s1(params, x, mcfg: ngp.NGPConfig, frames=None):
    """Deferred stage 1 (a sample): sigma and geo_feat as the flat
    feature row (``frames`` unused: the NGP has no chart)."""
    return ngp.density(params, x, mcfg, table_dtype=_infer_table_dtype(mcfg))


def ngp_deferred_s2(params, fbar, d, mcfg: ngp.NGPConfig):
    """Deferred stage 2 (a ray): the colour MLP on the composited
    geo_feat (the view direction is constant along a ray)."""
    return ngp.color(params, d, fbar, mcfg)


def ngp_background_image(params, pose, intrinsics, *, H: int, W: int,
                         mcfg: ngp.NGPConfig) -> torch.Tensor:
    """[H * W, 3] learned background-sphere colours of a whole frame
    (nerf/renderer.py:298-301: polar_from_ray -> the bg net), on the
    params' device; a frame's miss rays show them."""
    dev = params["bg_net"][0]["w"].device
    rays = get_rays(torch.as_tensor(pose, dtype=torch.float32, device=dev),
                    torch.as_tensor(intrinsics, dtype=torch.float32,
                                    device=dev), H, W)
    polar = polar_from_ray(rays["rays_o"], rays["rays_d"], mcfg.bg_radius)
    return ngp.background(params, polar, rays["rays_d"], mcfg)


def ngp_infer_params(params, mcfg: ngp.NGPConfig):
    """Params whose table is what inference reads: the bf16 [rows,
    row_width] copy when ``infer_table_bf16``.  Made once per set of
    parameters; params that already carry it are returned as they are."""
    if _infer_table_dtype(mcfg) is None or \
            params["grid"].dtype == torch.bfloat16:
        return params
    return {**params,
            "grid": inference_table(params["grid"], mcfg.packed_spec)}


@torch.no_grad()
def render_frame(params, occ: OccupancyGrid | None, pose, intrinsics,
                 H: int, W: int, mcfg: ngp.NGPConfig, rcfg: RenderConfig,
                 *, bg_color=1.0, prepass: PrepassState | None = None,
                 crop_aabb=None, plain_select: bool = False):
    """Render an H x W view of an NGP (``Trainer.render_frame``).

    params: NGP params (``ngp.init``, trained or converted), ideally
    passed through ``ngp_infer_params`` once; occ: the occupancy grid,
    from which the ``PrepassState`` is built unless ``prepass`` (built
    once per grid) is given.  ``crop_aabb`` and ``plain_select``: see
    ``render_image``.

    With ``mcfg.bg_radius`` > 0 the learned background sphere's image
    (``ngp_background_image``) replaces ``bg_color``, as in the JAX
    trainer's ``render_frame``.  ``rcfg.deferred`` shades once a ray
    (``ngp_deferred_s1`` / ``_s2``) on the proxy path.

    Returns dict(image [H, W, 3], depth [H, W], weights_sum [H, W],
    live, chunks)."""
    if prepass is None:
        prepass = PrepassState.build(occ.occ, rcfg, density=occ.density)
    if mcfg.bg_radius > 0:
        bg_color = ngp_background_image(params, pose, intrinsics, H=H, W=W,
                                        mcfg=mcfg)
    return render_image(ngp_field_apply, mcfg, ngp_infer_params(params, mcfg),
                        prepass, pose, intrinsics, H, W, rcfg,
                        bg_color=bg_color, sigma_apply=ngp_sigma_apply,
                        color_apply=ngp_color_apply, crop_aabb=crop_aabb,
                        deferred_apply=((ngp_deferred_s1, ngp_deferred_s2)
                                        if rcfg.deferred else None),
                        plain_select=plain_select)


class CheckpointMethods:
    """The checkpoint methods of both trainers (``Trainer``,
    ``CurvedTrainer``), over their ``state`` and ``workspace``.  A trainer
    that caches what it makes from its params or grid drops it in
    ``_params_replaced`` / ``_state_replaced``."""

    def save_checkpoint(self, path: str):
        """The whole state to the directory ``path``."""
        save_checkpoint(self.state, path)

    def load_checkpoint(self, path: str, strict: bool = True):
        """Load the state saved at ``path`` (in place; ``strict=False``:
        ``tolerant_load``)."""
        if strict:
            load_checkpoint(self.state, path)
        else:
            tolerant_load(self, path)
        self._state_replaced()

    def load_params(self, params) -> tuple[list[str], list[str]]:
        """Copy a loaded params tree into the params (``load_params``)."""
        out = load_params(self.state, params)
        self._params_replaced()
        return out

    def _params_replaced(self):
        pass

    def _state_replaced(self):
        self._params_replaced()

    def checkpoint(self, workspace: str | None = None,
                   max_keep: int = 2) -> str:
        """``save_rotating`` in ``workspace`` (default the trainer's)."""
        return save_rotating(self, _workspace(self, workspace),
                             max_keep=max_keep)

    def checkpoint_best(self, metric: float, workspace: str | None = None,
                        mode: str = "max") -> bool:
        """``save_best`` in ``workspace`` (default the trainer's)."""
        return save_best(self, metric, _workspace(self, workspace),
                         mode=mode)

    def load_latest(self, workspace: str | None = None) -> bool:
        path = latest_checkpoint(workspace or self.workspace or "")
        if path is None:
            return False
        self.load_checkpoint(path)
        return True

    def load_best(self, workspace: str | None = None) -> bool:
        path = best_checkpoint(workspace or self.workspace or "")
        if path is None:
            return False
        self.load_checkpoint(path)
        return True

    def resume(self, ckpt: str = "latest",
               workspace: str | None = None) -> str:
        """See ``resume``."""
        return resume(self, ckpt, workspace=workspace)


class Trainer(CheckpointMethods):
    """NGP training on one scene.

    dataset: poses [B, 4, 4], images [B, H, W, C] uint8, intrinsics [4],
    H, W, num_frames (``data.synthetic.SyntheticSphereDataset``,
    ``data.provider.NeRFDataset``).  The scene and the state live on
    ``device``; ``seed`` seeds the one generator that initialises the
    params and draws every step.  With a ``workspace`` the trainer logs
    to ``log_ngp.jsonl`` there, and its rotating and best checkpoints go
    to ``workspace/checkpoints``."""

    def __init__(self, dataset, model_cfg: ngp.NGPConfig,
                 render_cfg: RenderConfig, train_cfg: TrainConfig, *,
                 seed: int = 0, device: torch.device | str = "cuda",
                 workspace: str | None = None):
        self.device = torch.device(device)
        self.dataset = dataset
        self.workspace = workspace
        self.logger = (MetricsLogger(workspace, "ngp")
                       if workspace is not None else None)
        self.mcfg = model_cfg
        self.rcfg = render_cfg
        self.tcfg = train_cfg
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.state = init_train_state(self.generator, model_cfg, render_cfg,
                                      train_cfg)
        self.poses = torch.as_tensor(dataset.poses, device=self.device)
        self.images = torch.as_tensor(dataset.images, device=self.device)
        self.intrinsics = torch.as_tensor(dataset.intrinsics,
                                          device=self.device)
        self.H, self.W = dataset.H, dataset.W
        self._marked = False
        self._prepass: PrepassState | None = None
        self._prepass_occ: OccupancyGrid | None = None
        # the inference crop [6] of render_frame (the viewer's set_aabb);
        # None renders the whole grid
        self.crop_aabb = None

    def mark_untrained(self):
        self.state.occ = occ_mod.mark_untrained(
            self.state.occ, self.poses, self.intrinsics,
            grid_size=self.rcfg.grid_size, cascades=self.rcfg.cascades,
            bound=self.rcfg.bound)
        self._marked = True

    def train(self, steps: int, log_every: int = 0) -> dict[str, Any]:
        """Run ``steps`` iterations (a grid refresh every
        ``grid_update_interval`` steps).  Returns the last step's loss and
        mean samples per ray, and ``losses``, every step's loss (one host
        sync at the end; with ``log_every`` also one every that many
        steps, to print and log the step's metrics)."""
        if not self._marked:
            self.mark_untrained()
        tcfg, rcfg = self.tcfg, self.rcfg
        losses, metrics = [], {}
        step0 = self.state.step
        for i in range(steps):
            step = step0 + i
            if step % tcfg.grid_update_interval == 0:
                full = (step // tcfg.grid_update_interval
                        < tcfg.grid_full_updates)
                draws = occ_mod.grid_draws(
                    self.generator, grid_size=rcfg.grid_size,
                    cascades=rcfg.cascades, bound=rcfg.bound, full=full)
                grid_step(self.state, draws, mcfg=self.mcfg, rcfg=rcfg,
                          full=full, decay=tcfg.grid_decay)
            batch = sample_batch(self.generator,
                                 num_frames=self.dataset.num_frames,
                                 H=self.H, W=self.W, tcfg=tcfg)
            metrics = train_step(self.state, batch, self.poses, self.images,
                                 self.intrinsics, mcfg=self.mcfg, rcfg=rcfg,
                                 tcfg=tcfg, H=self.H, W=self.W)
            losses.append(metrics["loss"])
            if log_every and (i + 1) % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"step {step + 1}: loss={m['loss']:.5f} "
                      f"samples/ray={m['mean_samples']:.1f}")
                if self.logger is not None:
                    self.logger.log(step + 1, **m)
        out = {k: float(v) for k, v in metrics.items()}
        out["losses"] = torch.stack(losses).tolist() if losses else []
        return out

    def render_frame(self, pose, *, use_ema: bool = True, bg_color=1.0,
                     H=None, W=None):
        """Render a view of the current field within ``crop_aabb`` (the
        viewer's inference crop; None: the whole grid); the
        ``PrepassState`` is built once per occupancy refresh."""
        if self._prepass_occ is not self.state.occ:
            occ = self.state.occ
            self._prepass = PrepassState.build(occ.occ, self.rcfg,
                                               density=occ.density)
            self._prepass_occ = occ
        params = self.state.ema_params if use_ema else self.state.params
        return render_frame(params, None, pose, self.dataset.intrinsics,
                            H or self.H, W or self.W, self.mcfg, self.rcfg,
                            bg_color=bg_color, prepass=self._prepass,
                            crop_aabb=self.crop_aabb)

    def eval_psnr(self, frame_indices=None, *, use_ema: bool = True) -> float:
        """Mean PSNR of the given training frames (white background)."""
        vals = []
        for idx in frame_indices if frame_indices is not None else [0]:
            out = self.render_frame(self.dataset.poses[idx], use_ema=use_ema)
            gt = np.asarray(self.dataset.images[idx]).astype(
                np.float32) / 255.0
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
            vals.append(psnr(out["image"], gt))
        return float(np.mean(vals))

    def _state_replaced(self):
        # a loaded grid is a trained one: `train` must not mark it again
        self._marked = True


# ---------------------------------------------------------------------------
# checkpoints
#
# A checkpoint is a directory holding one ``torch.save`` file, CKPT_FILE,
# of the state as a tree of CPU tensors in the JAX state's layout:
#   params, opt_state = [{count, mu, nu}, {count}] (Adam's step count and
#   moments, as optax's (ScaleByAdamState, ScaleByScheduleState)),
#   ema_params, occ = {density, occ, mean_density, iter_density}, step,
#   and for the curved model error_map.
# It loads with ``torch.load(weights_only=True)``.  The random stream is
# not saved: a resumed trainer draws from its own seed.
# ---------------------------------------------------------------------------

CKPT_FILE = "state.pt"


def _workspace(trainer, workspace: str | None) -> str:
    ws = workspace or trainer.workspace
    if ws is None:
        raise ValueError("no workspace configured")
    return ws


def _detached(tree):
    return _map_params(lambda t: t.detach(), tree)


def state_tree(state, *, ema_as_params: bool = False) -> dict[str, Any]:
    """The checkpoint tree of a ``TrainState`` or ``CurvedTrainState``
    (views of its tensors; the moments of a leaf that has not stepped
    yet are zeros).  ``ema_as_params`` puts the EMA in ``params`` (the
    best checkpoint)."""
    opt = state.optimizer

    def moment(name):
        return _map_params(
            lambda p: opt.state[p][name].detach() if p in opt.state
            else torch.zeros_like(p, requires_grad=False), state.params)

    count = torch.tensor(state.step, dtype=torch.int32)
    o = state.occ
    tree = {
        "params": _detached(state.ema_params if ema_as_params
                            else state.params),
        "opt_state": [{"count": count, "mu": moment("exp_avg"),
                       "nu": moment("exp_avg_sq")}, {"count": count}],
        "ema_params": _detached(state.ema_params),
        "occ": {"density": o.density, "occ": o.occ,
                "mean_density": o.mean_density,
                "iter_density": o.iter_density},
        "step": count,
    }
    if getattr(state, "error_map", None) is not None:
        tree["error_map"] = state.error_map
    return tree


def save_checkpoint(state, path: str, *, ema_as_params: bool = False):
    """Write ``state_tree(state)`` to ``path/state.pt`` (the directory is
    made; the file is replaced atomically)."""
    os.makedirs(path, exist_ok=True)
    tree = _map_params(lambda t: t.cpu().clone(),
                       state_tree(state, ema_as_params=ema_as_params))
    tmp = os.path.join(path, CKPT_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, CKPT_FILE))


def read_checkpoint(path: str) -> dict[str, Any]:
    """The tree saved at the checkpoint directory ``path``, on the CPU."""
    return torch.load(os.path.join(path, CKPT_FILE), map_location="cpu",
                      weights_only=True)


def _paths(tree, p: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{p}.{k}" if p else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{p}[{i}]"))
        return out
    return {p: tree}


def _ordered(like, tree):
    """``tree`` with the dict keys in ``like``'s order (the leaf order
    that ``param_leaves`` reads)."""
    if isinstance(like, dict):
        return {k: _ordered(like[k], tree[k]) for k in like}
    if isinstance(like, (list, tuple)):
        return [_ordered(a, b) for a, b in zip(like, tree)]
    return tree


def _apply_tree(state, tree):
    """Copy a checkpoint tree of ``state``'s layout into ``state``: the
    params and the EMA in place (the optimizer keeps its tensors), Adam's
    moments and step count, the LR schedule at the saved step, the grid,
    the step and the error map."""
    dev = param_leaves(state.params)[0].device
    step = int(tree["step"])
    with torch.no_grad():
        for dst, src in ((state.params, tree["params"]),
                         (state.ema_params, tree["ema_params"])):
            for a, b in zip(param_leaves(dst),
                            param_leaves(_ordered(dst, src))):
                a.copy_(b)
    adam = tree["opt_state"][0]
    count = int(adam["count"])
    opt = state.optimizer
    opt.state.clear()
    if count > 0:
        for p, m, v in zip(param_leaves(state.params),
                           param_leaves(_ordered(state.params, adam["mu"])),
                           param_leaves(_ordered(state.params, adam["nu"]))):
            opt.state[p] = {"step": torch.tensor(float(count)),
                            "exp_avg": m.to(dev).clone(),
                            "exp_avg_sq": v.to(dev).clone()}
    sched = state.scheduler
    sched.last_epoch = count
    lrs = [base * fn(count) for base, fn in zip(sched.base_lrs,
                                                 sched.lr_lambdas)]
    for group, lr in zip(opt.param_groups, lrs):
        group["lr"] = lr
    sched._last_lr = lrs
    o = tree["occ"]
    state.occ = OccupancyGrid(
        density=o["density"].to(dev).clone(), occ=o["occ"].to(dev).clone(),
        mean_density=o["mean_density"].to(dev).clone(),
        iter_density=o["iter_density"].to(dev).clone())
    state.step = step
    if "error_map" in tree and getattr(state, "error_map", None) is not None:
        state.error_map = tree["error_map"].to(dev).clone()


def load_checkpoint(state, path: str):
    """Strict load: the checkpoint at ``path`` must hold exactly the
    state's leaves, each of the state's shape and dtype (else
    ValueError); then ``_apply_tree``."""
    tree = read_checkpoint(path)
    want = _paths(state_tree(state))
    got = _paths(tree)
    bad = sorted(set(want) ^ set(got))
    bad += [k for k in sorted(set(want) & set(got))
            if (tuple(want[k].shape), want[k].dtype)
            != (tuple(got[k].shape), got[k].dtype)]
    if bad:
        raise ValueError(f"checkpoint {path} does not match the state "
                         f"(load with strict=False to merge): {bad[:8]}")
    _apply_tree(state, tree)


def tolerant_merge(target, loaded, path: str = ""):
    """Merge a loaded tree into ``target`` (nested dicts / lists of
    tensors), keeping the target's value wherever ``loaded`` lacks a key
    or a leaf's shape or dtype differs.  Returns (merged, missing,
    unexpected), the key paths as the JAX package's ``tolerant_merge``
    writes them (``a.b[0].c``)."""
    missing: list[str] = []
    unexpected: list[str] = []

    def rec(tgt, src, p):
        if isinstance(tgt, dict):
            if not isinstance(src, dict):
                missing.append(p or "<root>")
                return tgt
            out = {}
            for k, v in tgt.items():
                cp = f"{p}.{k}" if p else str(k)
                if k in src:
                    out[k] = rec(v, src[k], cp)
                else:
                    missing.append(cp)
                    out[k] = v
            unexpected.extend(f"{p}.{k}" if p else str(k)
                              for k in src if k not in tgt)
            return out
        if isinstance(tgt, (list, tuple)):
            if not isinstance(src, (list, tuple)):
                missing.append(p or "<root>")
                return tgt
            out = []
            for i, v in enumerate(tgt):
                cp = f"{p}[{i}]"
                if i < len(src) and src[i] is not None:
                    out.append(rec(v, src[i], cp))
                else:
                    missing.append(cp)
                    out.append(v)
            unexpected.extend(f"{p}[{i}]" for i in range(len(tgt), len(src)))
            return type(tgt)(out)
        if src is None:
            missing.append(p)
            return tgt
        if not torch.is_tensor(src) or (tuple(src.shape), src.dtype) != (
                tuple(tgt.shape), tgt.dtype):
            shape = tuple(src.shape) if torch.is_tensor(src) else type(src)
            missing.append(f"{p} (shape/dtype mismatch: ckpt {shape}/"
                           f"{getattr(src, 'dtype', None)} vs "
                           f"{tuple(tgt.shape)}/{tgt.dtype})")
            return tgt
        return src

    merged = rec(target, loaded, path)
    return merged, missing, unexpected


def load_params(state, params) -> tuple[list[str], list[str]]:
    """Copy a loaded params tree into ``state.params`` in place, leaves it
    lacks kept (``tolerant_merge``); the optimizer, EMA, step and grid
    stay.  Returns (missing, unexpected)."""
    merged, missing, unexpected = tolerant_merge(_detached(state.params),
                                                 params)
    with torch.no_grad():
        for a, b in zip(param_leaves(state.params), param_leaves(merged)):
            a.copy_(b)
    return missing, unexpected


def tolerant_load(trainer, path: str) -> tuple[list[str], list[str]]:
    """Non-strict load: leaves the checkpoint lacks (or holds at another
    shape) keep their current values, leaves it has beyond the state are
    dropped; both are printed and returned (missing, unexpected)."""
    merged, missing, unexpected = tolerant_merge(
        state_tree(trainer.state), read_checkpoint(path))
    _apply_tree(trainer.state, merged)
    if missing:
        print(f"[load_checkpoint] missing keys kept at current values: "
              f"{missing}")
    if unexpected:
        print(f"[load_checkpoint] unexpected keys ignored: {unexpected}")
    return missing, unexpected


def resume(trainer, ckpt: str = "latest",
           workspace: str | None = None) -> str:
    """The reference's resume modes, on any trainer with ``state``,
    ``load_checkpoint`` and ``workspace``:

      'scratch'      -- no load
      'latest'       -- the newest rotating checkpoint, the whole state
      'latest_model' -- the newest rotating checkpoint's params only (the
                        optimizer, EMA, step and grid stay as they are)
      'best'         -- the best checkpoint (else as 'latest')
      <path>         -- that checkpoint directory, the whole state

    Returns what was loaded."""
    ws = workspace or getattr(trainer, "workspace", None)
    if ckpt == "scratch":
        return "scratch (no checkpoint loaded)"
    if ckpt in ("latest", "latest_model"):
        path = latest_checkpoint(ws) if ws else None
        if path is None:
            return "scratch (no latest checkpoint found)"
        if ckpt == "latest_model":
            params = read_checkpoint(path).get("params")
            if params is None:
                return f"scratch (no params in {path})"
            missing, unexpected = trainer.load_params(params)
            if missing or unexpected:
                print(f"[resume latest_model] missing={missing} "
                      f"unexpected={unexpected}")
            return f"model weights from {path}"
        trainer.load_checkpoint(path)
        return f"full state from {path}"
    if ckpt == "best":
        path = best_checkpoint(ws) if ws else None
        if path is None:
            return resume(trainer, "latest", workspace=ws) + \
                " (no best checkpoint, fell back to latest)"
        trainer.load_checkpoint(path)
        return f"best checkpoint from {path}"
    trainer.load_checkpoint(ckpt)
    return f"full state from {ckpt}"


def save_rotating(trainer, workspace: str, *, max_keep: int = 2,
                  prefix: str = "ckpt") -> str:
    """Write ``{workspace}/checkpoints/{prefix}_{step:08d}`` and remove all
    but the newest ``max_keep``."""
    root = os.path.join(workspace, "checkpoints")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{prefix}_{trainer.state.step:08d}")
    trainer.save_checkpoint(path)
    kept = sorted(d for d in os.listdir(root) if d.startswith(prefix + "_"))
    for stale in kept[:-max_keep]:
        shutil.rmtree(os.path.join(root, stale), ignore_errors=True)
    return path


def latest_checkpoint(workspace: str, prefix: str = "ckpt") -> str | None:
    root = os.path.join(workspace, "checkpoints")
    if not os.path.isdir(root):
        return None
    kept = sorted(d for d in os.listdir(root) if d.startswith(prefix + "_"))
    return os.path.join(root, kept[-1]) if kept else None


def save_best(trainer, metric: float, workspace: str, *,
              mode: str = "max") -> bool:
    """Save ``{workspace}/checkpoints/best`` when ``metric`` improves on
    the one ``best.json`` records ('max' or 'min'), with the EMA as its
    params (the reference saves EMA-swapped weights); update
    ``best.json``.  Returns whether it saved."""
    root = os.path.join(workspace, "checkpoints")
    os.makedirs(root, exist_ok=True)
    meta_path = os.path.join(root, "best.json")
    prev = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            prev = json.load(f).get("metric")
    improved = (prev is None
                or (metric > prev if mode == "max" else metric < prev))
    if not improved:
        return False
    save_checkpoint(trainer.state, os.path.join(root, "best"),
                    ema_as_params=True)
    with open(meta_path, "w") as f:
        json.dump({"metric": float(metric), "step": int(trainer.state.step),
                   "mode": mode}, f)
    return True


def best_checkpoint(workspace: str) -> str | None:
    path = os.path.join(workspace, "checkpoints", "best")
    return path if os.path.isdir(path) else None
