"""Training and rendering of the Instant-NGP stage (port of
``nerf_texture_tpu/train/trainer.py``).

One training step:

  frame + pixel draws -> ray gen -> occupancy march (jittered) ->
  compacted sample pool -> field (AMP table read) -> composite -> MSE ->
  backward -> Adam (+ LambdaLR decay) -> EMA of the parameters

and every ``grid_update_interval`` steps a density-grid refresh.  The
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
from typing import Any, NamedTuple

import numpy as np
import torch

from ..data.rays import get_rays, sample_ray_indices
from ..models import ngp
from ..ops import occupancy as occ_mod
from ..ops.hashgrid_packed import inference_table
from ..ops.occupancy import OccupancyGrid
from ..render.renderer import (PrepassState, RenderConfig, render_image,
                               render_rays)
from ..utils.metrics import psnr


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
    out = render_rays(lambda x, d: ngp.forward(params, x, d, mcfg), occ.occ,
                      rays["rays_o"], rays["rays_d"], rcfg,
                      max_samples=rcfg.max_samples_train, perturb=True,
                      u=batch.u, bg_color=bg)
    return torch.mean((out["image"] - gt_rgb) ** 2), out


def apply_gradients(state, tcfg: TrainConfig):
    """The update after a backward, of a ``TrainState`` or a curved
    ``CurvedTrainState``: Adam on the params' ``.grad``, one step of the
    LR decay, the EMA of the new params; ``state.step`` + 1."""
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
                 plain_select: bool = False):
    """Render an H x W view of an NGP (``Trainer.render_frame``).

    params: NGP params (``ngp.init``, trained or converted), ideally
    passed through ``ngp_infer_params`` once; occ: the occupancy grid,
    from which the ``PrepassState`` is built unless ``prepass`` (built
    once per grid) is given.  ``plain_select``: see ``render_image``.

    Returns dict(image [H, W, 3], depth [H, W], weights_sum [H, W],
    live, chunks)."""
    if mcfg.bg_radius > 0:
        raise NotImplementedError(
            "render_frame: the learned background sphere (bg_radius > 0) is "
            "not ported yet (ROADMAP Queue 1, item 3)")
    if rcfg.deferred:
        raise NotImplementedError(
            "render_frame: deferred shading is not ported (ROADMAP Queue 1, "
            "item 12: port it only if an H100 profile asks for it)")
    if prepass is None:
        prepass = PrepassState.build(occ.occ, rcfg, density=occ.density)
    return render_image(ngp_field_apply, mcfg, ngp_infer_params(params, mcfg),
                        prepass, pose, intrinsics, H, W, rcfg,
                        bg_color=bg_color, sigma_apply=ngp_sigma_apply,
                        color_apply=ngp_color_apply,
                        plain_select=plain_select)


class Trainer:
    """NGP training on one scene.

    dataset: poses [B, 4, 4], images [B, H, W, C] uint8, intrinsics [4],
    H, W, num_frames (``data.synthetic.SyntheticSphereDataset``).  The
    scene and the state live on ``device``; ``seed`` seeds the one
    generator that initialises the params and draws every step."""

    def __init__(self, dataset, model_cfg: ngp.NGPConfig,
                 render_cfg: RenderConfig, train_cfg: TrainConfig, *,
                 seed: int = 0, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.dataset = dataset
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

    def mark_untrained(self):
        self.state.occ = occ_mod.mark_untrained(
            self.state.occ, self.poses, self.intrinsics,
            grid_size=self.rcfg.grid_size, cascades=self.rcfg.cascades,
            bound=self.rcfg.bound)
        self._marked = True

    def train(self, steps: int) -> dict[str, Any]:
        """Run ``steps`` iterations (a grid refresh every
        ``grid_update_interval`` steps).  Returns the last step's loss and
        mean samples per ray, and ``losses``, every step's loss (one host
        sync at the end)."""
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
        out = {k: float(v) for k, v in metrics.items()}
        out["losses"] = torch.stack(losses).tolist() if losses else []
        return out

    def render_frame(self, pose, *, use_ema: bool = True, bg_color=1.0,
                     H=None, W=None):
        """Render a view of the current field; the ``PrepassState`` is
        built once per occupancy refresh."""
        if self._prepass_occ is not self.state.occ:
            occ = self.state.occ
            self._prepass = PrepassState.build(occ.occ, self.rcfg,
                                               density=occ.density)
            self._prepass_occ = occ
        params = self.state.ema_params if use_ema else self.state.params
        return render_frame(params, None, pose, self.dataset.intrinsics,
                            H or self.H, W or self.W, self.mcfg, self.rcfg,
                            bg_color=bg_color, prepass=self._prepass)

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
