"""Training and serving of the NeRF-Texture curved-field model (port of
``nerf_texture_tpu/train/curved_trainer.py``).

One training step (``curved_train_step``):

  frame + pixel draws -> ray gen -> occupancy march (jittered) ->
  compacted sample pool -> per-sample anchor frames from the anchor
  table -> curved field with noisy features and the -grad(sigma) normal
  target -> composite (normals on detached weights) -> MSE on a random
  per-pixel background + the composited-normal cosine loss + the
  regularisers -> backward -> Adam (+ LambdaLR decay) -> EMA

``CurvedTrainer`` holds a curved model over its template mesh:

  train(steps): the step loop, with a density-grid refresh every
    ``grid_update_interval`` steps;
  initialize_states(n): n density-grid refreshes over the near-surface
    cells, each point anchored through the per-cell anchor table;
  render_frame(pose): the live proxy render -- block prepass, proxy
    sweep over the density grid, ``proxy_select_cdf`` placing the
    survivors (with ``proxy_samples`` > 0 a coarse round narrows the
    span first and ``proxy_select`` picks them), the curved field on the
    survivors, exact composite;
  render_frame(pose, parity=True): the pool render -- occupancy march,
    compacted pool, sigma over the pool, ``survivor_pool``, colour on
    the survivors;
  render_frame(pose, baked=True): the live proxy render through the
    baked atlas (``bake_atlas``, ``render.baked``);
  eval_psnr(frames): PSNR of the training views.

The JAX trainer's ``lru``/``id()`` caches become explicit state here: the
anchor table is built once per template mesh, the inference tables
(bf16 copies of the hash grids) and the baked atlas once per parameter
version (the params are updated in place, so a version, not their
identity, says when they changed), and a ``PrepassState`` once per
occupancy grid and render config (a refresh makes a new grid; nothing
updates one in place).  The random draws of a step and of a refresh come
from the trainer's ``torch.Generator`` (``sample_curved_batch``,
``occupancy.sparse_draws``), or from the caller of ``curved_train_step``
and ``curved_grid_step``.  The JAX package's ``curved_train_scan`` (steps
fused into one TPU program) is a plain loop here.

An imported texture (``train.field_io``: mode 'field', 'patch', 'shape'
or 'unhash') renders through the same calls; its grid refresh evaluates
the import mode's field at every near cell (the anchor table is the
trained field's alone), over the z = 0 slab of the flat canvas or the
cells near the imported mesh or points.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP
item): the training features of item 11.4 (distillation, camera and
gamma optimisation, error-map sampling, progressive vertex levels),
training in an import mode (item 11.2: the reference has no caller of a
pose-free refit of an import), and the deferred shading of the baked
render (item 12).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from ..data.rays import get_rays, sample_ray_indices
from ..geometry import projector as proj
from ..models import curved_field, normal_net
from ..models.curved_field import CurvedFieldConfig
from ..models.mesh_field import FieldRuntime, MeshFieldConfig, MeshFieldState
from ..ops import occupancy as occ_mod
from ..ops.hashgrid_packed import inference_table, packed_encode_bound
from ..ops.occupancy import OccupancyGrid
from ..render import baked as baked_mod
from ..render.renderer import (PrepassState, RenderConfig, _round_up,
                               render_image, render_rays)
from ..utils.metrics import psnr
from .trainer import (TrainConfig, _map_params, apply_gradients,
                      make_optimizer, param_leaves)


@dataclasses.dataclass(frozen=True)
class CurvedTrainConfig(TrainConfig):
    """Every field of the JAX CurvedTrainConfig."""

    lr: float = 1e-2
    total_steps: int = 40000
    normal_cosine_threshold: float = math.cos(math.pi / 8)
    normal_coarse_weight: float = 1e-4
    distillation: bool = False
    distillation_prob: float = 0.75
    optimize_camera: bool = False
    camera_reg_weight: float | None = None
    optimize_gamma: bool = False
    error_map: bool = False
    scan_steps: int = 8
    iters_per_level: int = 0


@dataclasses.dataclass
class CurvedTrainState:
    """Mutable training state on one device.  ``step`` counts the
    updates; the params and their EMA change in place, so ``step`` is
    also the version of both that the trainer's caches key on."""

    params: dict[str, Any]
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    ema_params: dict[str, Any]
    occ: OccupancyGrid
    step: int = 0


def init_curved_state(generator: torch.Generator, ccfg: CurvedFieldConfig,
                      rcfg: RenderConfig, tcfg: "CurvedTrainConfig",
                      params=None) -> CurvedTrainState:
    """Fresh state on the generator's device: seeded params (or the given
    ones, e.g. converted from JAX, copied), zero Adam moments, the EMA
    equal to the params, an empty occupancy grid."""
    if params is None:
        params = curved_field.init(generator, ccfg)
    params = _map_params(lambda t: t.detach().clone().requires_grad_(True),
                         params)
    opt, sched = make_optimizer(params, tcfg)
    return CurvedTrainState(
        params=params, optimizer=opt, scheduler=sched,
        ema_params=_map_params(lambda t: t.detach().clone(), params),
        occ=occ_mod.create(rcfg.grid_size, rcfg.cascades,
                           device=generator.device))


class CurvedBatch(NamedTuple):
    """The random draws of one curved training step."""

    frame: torch.Tensor          # [] int64 training frame
    inds: torch.Tensor           # [num_rays] int64 pixel indices
    u: torch.Tensor              # [num_rays] f32 march jitter in [0, 1)
    bg: torch.Tensor             # [num_rays, 3] f32 per-pixel background
    noise: torch.Tensor | None   # [M, L * C] N(0, 1) feature noise
    level: int | None            # the clustering level


def noise_rows(rcfg: RenderConfig, num_rays: int) -> int:
    """Samples the field sees in a training step, the rows of its feature
    noise: the pool budget (``render_rays``' rounding), or the dense
    [N, max_samples_train] march without a pool."""
    if rcfg.pool_mean_samples:
        return _round_up(num_rays * rcfg.pool_mean_samples, 1024)
    return num_rays * rcfg.max_samples_train


def sample_curved_batch(generator: torch.Generator, *, num_frames: int,
                        H: int, W: int, tcfg: "CurvedTrainConfig",
                        rcfg: RenderConfig, fcfg: MeshFieldConfig,
                        level: int | None) -> CurvedBatch:
    """A training step's draws on the generator's device: a frame, the
    pixel indices, the march jitter, a per-pixel background and (with
    ``prob_model``) the feature noise.  ``level`` is the clustering level,
    a host int that the caller draws (``CurvedTrainer.train`` draws a
    whole call's levels from the same generator in one transfer, so no
    step waits for the card)."""
    dev = generator.device
    frame = torch.randint(0, num_frames, (), generator=generator,
                          device=dev)
    inds, _ = sample_ray_indices(generator, H, W, tcfg.num_rays)
    u = torch.rand((tcfg.num_rays,), generator=generator, device=dev)
    bg = torch.rand((tcfg.num_rays, 3), generator=generator, device=dev)
    noise = None
    if fcfg.prob_model:
        noise = torch.randn((noise_rows(rcfg, tcfg.num_rays),
                             fcfg.encoder_f_out_dim), generator=generator,
                            device=dev)
    return CurvedBatch(frame=frame, inds=inds, u=u, bg=bg, noise=noise,
                       level=level if fcfg.clustering else None)


def _check_training_features(tcfg: "CurvedTrainConfig", mode: str):
    for name, on in (("distillation", tcfg.distillation),
                     ("optimize_camera", tcfg.optimize_camera),
                     ("optimize_gamma", tcfg.optimize_gamma),
                     ("error_map", tcfg.error_map),
                     ("iters_per_level", tcfg.iters_per_level > 0)):
        if on:
            raise NotImplementedError(
                f"curved training: {name} is not ported; ROADMAP Queue 1, "
                f"item 11.4")
    if mode != "none":
        raise NotImplementedError(
            f"curved training: import mode {mode!r} is not ported; ROADMAP "
            f"Queue 1, item 11.2")


def curved_train_loss(params, occ: OccupancyGrid, batch: CurvedBatch,
                      field_state: MeshFieldState, poses, images,
                      intrinsics, *, ccfg: CurvedFieldConfig,
                      rcfg: RenderConfig, tcfg: "CurvedTrainConfig",
                      H: int, W: int, step: int = 0, mode: str = "none",
                      rt=None, anchor_tab=None):
    """(loss [], render output) of one batch, differentiable in params:
    the MSE against the pixels composited on the batch's background, the
    cosine loss of the composited fine normals against their
    -grad(sigma) target (rays with a finite, non-zero target; the
    cosine is capped at ``normal_cosine_threshold``), and
    ``curved_field.regular_loss`` at the batch's clustering level.
    poses [B, 4, 4], images [B, H, W, C] uint8, intrinsics [4] on the
    params' device; ``anchor_tab``: the per-sample anchors (with
    ``anchor_per_sample``), else one kNN anchor a ray."""
    _check_training_features(tcfg, mode)
    rays = get_rays(poses[batch.frame], intrinsics, H, W, batch.inds)
    pixels = images[batch.frame].reshape(H * W, -1)[batch.inds].to(
        torch.float32) / 255.0
    if pixels.shape[-1] == 4:
        gt_rgb = pixels[:, :3] * pixels[:, 3:] \
            + batch.bg * (1.0 - pixels[:, 3:])
    else:
        gt_rgb = pixels[:, :3]
    anchor = None
    rcfg_eff = rcfg
    if _use_frames(ccfg, mode):
        if anchor_tab is not None and rcfg.anchor_per_sample:
            def anchor(o, d, xs, sv):
                return proj.anchor_frames_from_table(anchor_tab, xs, sv,
                                                     ccfg.bound)
        else:
            def anchor(o, d, xs, sv):
                return _ray_frames(field_state, xs, sv, ccfg)
            rcfg_eff = dataclasses.replace(rcfg, anchor_per_sample=False)

    def field(x, d, frames=None):
        return curved_field.forward(params, field_state, x, d, ccfg, rt,
                                    mode=mode, noise=batch.noise,
                                    training=True, frames=frames)

    out = render_rays(field, occ.occ, rays["rays_o"], rays["rays_d"],
                      rcfg_eff, max_samples=rcfg.max_samples_train,
                      perturb=True, u=batch.u, bg_color=batch.bg,
                      anchor_fn=anchor)
    loss = torch.mean(torch.mean((out["image"] - gt_rgb) ** 2, dim=-1))
    if "normal" in out and "normal_grad" in out:
        n_est = out["normal"]
        n_grad = out["normal_grad"].detach()
        # eps inside the rsqrt: the all-zero normals of empty rays would
        # give a NaN gradient of the norm
        finite = (torch.all(torch.isfinite(n_grad), dim=-1)
                  & (torch.sum(n_grad * n_grad, -1) > 1e-8))
        n_est_n = n_est * torch.rsqrt(
            torch.sum(n_est * n_est, -1, keepdim=True) + 1e-10)
        n_grad_n = n_grad * torch.rsqrt(
            torch.sum(n_grad * n_grad, -1, keepdim=True) + 1e-10)
        cos = torch.sum(n_grad_n * n_est_n, dim=-1)
        thr = tcfg.normal_cosine_threshold if not ccfg.no_visibility else 1.0
        err = -torch.clamp(cos, max=thr)
        loss = loss + torch.sum(torch.where(finite, err, 0.0)) \
            / torch.clamp(torch.sum(finite), min=1)
    loss = loss + curved_field.regular_loss(params, ccfg, step,
                                            level=batch.level)
    return loss, out


def curved_train_step(state: CurvedTrainState, batch: CurvedBatch,
                      field_state: MeshFieldState, poses, images,
                      intrinsics, *, ccfg: CurvedFieldConfig,
                      rcfg: RenderConfig, tcfg: "CurvedTrainConfig",
                      H: int, W: int, mode: str = "none", rt=None,
                      anchor_tab=None) -> dict[str, torch.Tensor]:
    """One iteration on ``batch``: loss, backward into the params only
    (not into the sample points that the -grad(sigma) target
    differentiated), ``apply_gradients``.  Updates ``state`` in place;
    returns device scalars (no host sync)."""
    loss, _ = curved_train_loss(
        state.params, state.occ, batch, field_state, poses, images,
        intrinsics, ccfg=ccfg, rcfg=rcfg, tcfg=tcfg, H=H, W=W,
        step=state.step, mode=mode, rt=rt, anchor_tab=anchor_tab)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward(inputs=param_leaves(state.params))
    apply_gradients(state, tcfg)
    return {"loss": loss.detach()}


def _use_frames(ccfg: CurvedFieldConfig, mode: str) -> bool:
    """Anchor frames apply to the hash encoder in mode 'none' with
    per-ray projection."""
    return (ccfg.field.per_ray_projection and mode == "none"
            and ccfg.field.encoder_type == "hash")


def _ray_frames(field_state: MeshFieldState, x_seed, seed_valid,
                ccfg: CurvedFieldConfig):
    """Anchor frames by kNN from seed points (no table)."""
    return proj.seed_anchor_frames(
        field_state.projector, x_seed, seed_valid, k=ccfg.field.k,
        max_dist=4.0 * ccfg.field.h_threshold)


def compute_near_cells(vertices: np.ndarray, grid_size: int, bound: float,
                       h_threshold: float) -> np.ndarray:
    """Flat ids (int32) of the grid cells within the shell margin of the
    mesh (host cKDTree over the cell centres)."""
    from scipy.spatial import cKDTree

    H = grid_size
    centers = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    half = bound / H
    centers = centers * (bound - half) / (1.0 - 1.0 / H)
    xx, yy, zz = np.meshgrid(centers, centers, centers, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], -1)
    d, _ = cKDTree(vertices).query(pts, workers=-1)
    cell_diag = 2 * bound / H * np.sqrt(3)
    return np.where(d < 2 * h_threshold + cell_diag)[0].astype(np.int32)


def _curved_cell_sigma(params, field_state, rt, cell_ids, noise, *,
                       ccfg: CurvedFieldConfig, rcfg: RenderConfig,
                       mode: str, cas: int):
    """Refresh densities of cells ``cell_ids`` at their jittered points
    through the field of ``mode`` (in mode 'none' the exact projection
    of every point)."""
    pts = occ_mod.cell_points(cell_ids, noise, grid_size=rcfg.grid_size,
                              cas=cas, bound=rcfg.bound)
    sigma, _ = curved_field.density(params, field_state, pts, ccfg, rt,
                                    mode=mode)
    return sigma * rcfg.density_scale


def _curved_cell_sigma_anchored(params, field_state, rt, anchor_tab,
                                cell_ids, noise, *, ccfg: CurvedFieldConfig,
                                rcfg: RenderConfig, mode: str, cas: int):
    """Refresh densities of cells ``cell_ids`` at their jittered points,
    each anchored by one row gather from the anchor table."""
    pts = occ_mod.cell_points(cell_ids, noise, grid_size=rcfg.grid_size,
                              cas=cas, bound=rcfg.bound)
    frames = proj.anchor_frames_from_table(
        anchor_tab, pts, torch.ones(pts.shape[:1], dtype=torch.bool,
                                    device=pts.device), ccfg.bound)
    sigma, _ = curved_field.density(params, field_state, pts, ccfg, rt,
                                    mode=mode, frames=frames)
    return sigma * rcfg.density_scale


@torch.no_grad()
def curved_grid_step(state: CurvedTrainState, field_state: MeshFieldState,
                     draws, *, ccfg: CurvedFieldConfig, rcfg: RenderConfig,
                     full: bool = True, mode: str = "none", rt=None,
                     near_cells=None, anchor_tab=None) -> CurvedTrainState:
    """Density-grid refresh over the near-surface cells (the field is a
    thin shell around its template); replaces ``state.occ``.

    draws: per cascade, the [len(near_cells), 3] jitter
    (``occupancy.sparse_draws``).  With ``anchor_tab`` (mode 'none', hash
    encoder, per-ray projection) each point anchors through the table;
    otherwise the field of ``mode`` runs on each point (in mode 'none'
    that is the exact projection).  Either way in chunks of 262,144
    cells: an import's field is a chain of small ops (the ray casts of
    ``uvh``), so larger chunks launch fewer of them.  Without
    ``near_cells`` they are computed around the imported mesh or points
    ('shape', 'unhash', 'patch') or the template.  Like the JAX
    function, the refresh decays the grid at ``update_host_sparse``'s
    default 0.95, not at ``TrainConfig.grid_decay``."""
    if near_cells is None:
        arr = (field_state.projector_imported
               if mode in ("shape", "unhash", "patch")
               else field_state.projector)
        near_cells = compute_near_cells(
            arr.vertices.cpu().numpy(), rcfg.grid_size, rcfg.bound,
            ccfg.field.h_threshold)
    near_cells = torch.as_tensor(near_cells).to(
        device=state.occ.density.device, dtype=torch.int64)
    if anchor_tab is not None and _use_frames(ccfg, mode):
        def chunk_fn(ids, noise, cas):
            return _curved_cell_sigma_anchored(
                state.params, field_state, rt, anchor_tab, ids, noise,
                ccfg=ccfg, rcfg=rcfg, mode=mode, cas=cas)
    else:
        def chunk_fn(ids, noise, cas):
            return _curved_cell_sigma(state.params, field_state, rt, ids,
                                      noise, ccfg=ccfg, rcfg=rcfg,
                                      mode=mode, cas=cas)
    state.occ = occ_mod.update_host_sparse(
        state.occ, chunk_fn, draws, near_cells, grid_size=rcfg.grid_size,
        cascades=rcfg.cascades, density_thresh=rcfg.density_thresh,
        chunk=262144)
    return state


def canvas_near_cells(grid_size: int, bound: float,
                      h_threshold: float) -> np.ndarray:
    """Flat ids (int32) of the cells of the z = 0 slab that a flat canvas
    ('field' mode) occupies: every (x, y), z within 2 h_threshold + two
    cells of the plane."""
    H = grid_size
    z = ((np.arange(H) + 0.5) / H * 2.0 - 1.0) * bound
    zi = np.where(np.abs(z) < 2 * h_threshold + 4 * bound / H)[0]
    return (np.arange(H * H)[:, None] * H + zi[None, :]).ravel().astype(
        np.int32)


# ---------------------------------------------------------------------------
# field functions of the render: bundle = {'params', 'field_state', 'rt'
# [, 'anchor_tab']}, static = (ccfg, mode, visual_mode, light_visual_mode)
# ---------------------------------------------------------------------------

def curved_field_apply(bundle, x, d, static, frames=None):
    """(sigma, rgb) of the one-pass shading forward."""
    ccfg, mode, visual_mode, light_visual_mode = static
    sigma, color, _ = curved_field.forward(
        bundle["params"], bundle["field_state"], x, d, ccfg, bundle["rt"],
        mode=mode, training=False, visual_mode=visual_mode,
        light_visual_mode=light_visual_mode, frames=frames)
    return sigma, color


def curved_anchor_apply(bundle, rays_o, rays_d, x_seed, seed_valid,
                        static):
    """Anchor frames of points: one row gather from bundle['anchor_tab'],
    or without a table the kNN frames of ``seed_anchor_frames``."""
    ccfg = static[0]
    tab = bundle.get("anchor_tab")
    if tab is not None:
        return proj.anchor_frames_from_table(tab, x_seed, seed_valid,
                                             ccfg.bound)
    return _ray_frames(bundle["field_state"], x_seed, seed_valid, ccfg)


def curved_sigma_apply(bundle, x, d, static, frames=None):
    """Sigma phase of the pool render: (sigma, aux) without the normal
    net or the light model."""
    ccfg, mode = static[0], static[1]
    return curved_field.sigma_with_aux(
        bundle["params"], bundle["field_state"], x, d, ccfg, bundle["rt"],
        mode=mode, frames=frames)


def curved_color_apply(bundle, x, d, aux, static, frames=None):
    """Colour phase of the pool render on the survivors, from aux."""
    ccfg, _, visual_mode, light_visual_mode = static
    return curved_field.color_from_aux(
        bundle["params"], bundle["field_state"], x, d, aux, ccfg,
        bundle["rt"], frames, visual_mode=visual_mode,
        light_visual_mode=light_visual_mode)


def curved_field_apply_baked(bundle, x, d, static, frames=None):
    """(sigma, rgb) through the baked atlas bundle['bake'] (mode 'none',
    RGB)."""
    ccfg, _, _, light_visual_mode = static
    return curved_field.forward_baked(
        bundle["params"], bundle["bake"], x, d, ccfg, bundle["rt"], frames,
        light_visual_mode=light_visual_mode)


def curved_anchor_apply_baked(bundle, rays_o, rays_d, x_seed, seed_valid,
                              static):
    """Anchor frames and tile addressing by one row gather from the
    extended anchor table bundle['anchor_ext']."""
    return baked_mod.anchor_frames_ext(bundle["bake"], bundle["anchor_ext"],
                                       x_seed, seed_valid)


def _bake_encode_chunk(enc, nparams, pts, fcfg: MeshFieldConfig):
    """The baked channels at world points [P, 3]: the feature pyramid
    (f32 table, its mean lanes) and, with ``pred_normal``, the phi
    embedding: [P, F (+ P_phi)]."""
    x_embed = packed_encode_bound(pts, enc, fcfg.feature_spec,
                                  bound=fcfg.bound, amp=False)
    if not fcfg.pred_normal:
        return x_embed
    phi = normal_net.phi_embedding(nparams, pts, fcfg.normal_cfg, amp=False)
    return torch.cat([x_embed, phi], dim=-1)


@torch.no_grad()
def curved_infer_params(params, ccfg: CurvedFieldConfig):
    """Params whose hash grids are what inference reads: with
    ``infer_table_bf16`` the bf16 [rows, row_width] copies of the
    encoder table (its mean lanes) and of the phi grid.  The copies are
    taken now: params updated afterwards need new ones."""
    fcfg = ccfg.field
    if not fcfg.infer_table_bf16:
        return params
    field = dict(params["field"])
    if field["encoder"].dtype != torch.bfloat16:
        field["encoder"] = inference_table(field["encoder"],
                                           fcfg.feature_spec)
    if fcfg.pred_normal and field["normal"]["phi_grid"].dtype \
            != torch.bfloat16:
        field["normal"] = dict(field["normal"], phi_grid=inference_table(
            field["normal"]["phi_grid"], fcfg.normal_cfg.phi_grid_spec))
    return dict(params, field=field)


class CurvedTrainer:
    """The curved model on one scene and template mesh.

    dataset: poses [B, 4, 4], images [B, H, W, C] uint8, intrinsics [4],
    H, W, num_frames (``data.synthetic.SyntheticSphereDataset``);
    field_state: ``mesh_field.make_state(MeshProjector(mesh,
    device=device))``.  The params are seeded from ``seed``; to start
    from others (e.g. converted JAX params), replace ``state`` with
    ``init_curved_state(tr.generator, ..., params=params)``, or, to
    render only, set ``state.params`` / ``ema_params``.  Everything lives
    on ``device``."""

    def __init__(self, dataset, field_state: MeshFieldState,
                 ccfg: CurvedFieldConfig, rcfg: RenderConfig,
                 tcfg: CurvedTrainConfig, *, seed: int = 0,
                 device: torch.device | str = "cuda"):
        # the concrete device ("cuda" -> cuda:<current>), as a tensor's
        # device reads; raises where there is no such device
        self.device = torch.empty(0, device=device).device
        if field_state.projector.vertices.device != self.device:
            raise ValueError(
                f"CurvedTrainer on {self.device}: the field state lives on "
                f"{field_state.projector.vertices.device} (build the "
                f"MeshProjector with device={self.device})")
        self.dataset = dataset
        self.field_state = field_state
        self.ccfg, self.rcfg, self.tcfg = ccfg, rcfg, tcfg
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.state = init_curved_state(self.generator, ccfg, rcfg, tcfg)
        self.poses = torch.as_tensor(dataset.poses, device=self.device)
        self.images = torch.as_tensor(dataset.images, device=self.device)
        self.intrinsics = torch.as_tensor(dataset.intrinsics,
                                          device=self.device)
        self.H, self.W = dataset.H, dataset.W
        self.mode = "none"
        self.runtime = FieldRuntime.default()
        self.visual_mode = "RGB"
        self.light_visual_mode = "Full"
        # per-cell anchor table, built once per template mesh; collapsed
        # columns give one chart per surface patch through the shell
        self.anchor_cache = True
        self.anchor_collapse = True
        self._anchor_tab = None          # (projector, collapse, table)
        # ((projector, imported projector, mode), cell ids)
        self._near_cells = None
        # (params, step, inference params), for the params and the EMA
        self._infer: list[tuple] = []
        # (params, step, grid, T, atlas, extended table)
        self._bake: list[tuple] = []
        self._prepass_occ = None         # the grid the prepasses are of
        self._prepass: dict[RenderConfig, PrepassState] = {}

    def train(self, steps: int) -> dict[str, Any]:
        """Run ``steps`` iterations, refreshing the density grid before
        every step whose count is a multiple of ``grid_update_interval``
        (always over the near cells, so ``grid_full_updates`` does not
        apply, as in the JAX trainer).  ``tcfg.scan_steps`` has no effect:
        the JAX package fuses that many steps into one TPU program, here
        the steps are a plain loop.

        Returns the last step's loss and ``losses``, every step's loss
        (one host sync at the end)."""
        _check_training_features(self.tcfg, self.mode)
        leaves = param_leaves(self.state.params)
        held = self.state.optimizer.param_groups[0]["params"]
        if len(held) != len(leaves) or any(a is not b
                                           for a, b in zip(held, leaves)):
            raise ValueError(
                "CurvedTrainer.train: state.params are not the params of "
                "state.optimizer; build the state with init_curved_state("
                "..., params=params)")
        fcfg = self.ccfg.field
        # the clustering levels of the whole call, in one transfer
        levels = (torch.randint(0, fcfg.num_levels, (steps,),
                                generator=self.generator,
                                device=self.device).tolist()
                  if fcfg.clustering else [None] * steps)
        losses = []
        for i in range(steps):
            if self.state.step % self.tcfg.grid_update_interval == 0:
                self._refresh()
            batch = sample_curved_batch(
                self.generator, num_frames=self.dataset.num_frames,
                H=self.H, W=self.W, tcfg=self.tcfg, rcfg=self.rcfg,
                fcfg=fcfg, level=levels[i])
            m = curved_train_step(
                self.state, batch, self.field_state, self.poses,
                self.images, self.intrinsics, ccfg=self.ccfg,
                rcfg=self.rcfg, tcfg=self.tcfg, H=self.H, W=self.W,
                mode=self.mode, rt=self.runtime,
                anchor_tab=self._refresh_anchor_tab())
            losses.append(m["loss"])
        losses = torch.stack(losses).tolist() if losses else []
        return {"loss": losses[-1] if losses else float("nan"),
                "losses": losses}

    def _anchor_table(self) -> torch.Tensor:
        """Per-cell anchor frames, built once per template mesh."""
        p = self.field_state.projector
        if (self._anchor_tab is None or self._anchor_tab[0] is not p
                or self._anchor_tab[1] != self.anchor_collapse):
            fcfg = self.ccfg.field
            cell = 2.0 * self.rcfg.bound / self.rcfg.grid_size
            # the hit gate of the kNN frames, widened by the cell-centre
            # offset (the table is sampled at cell centres)
            self._anchor_tab = (p, self.anchor_collapse,
                                proj.build_anchor_table(
                p, self.rcfg.grid_size, self.rcfg.bound, k=fcfg.k,
                max_dist=4.0 * fcfg.h_threshold + 2.0 * cell,
                collapse_columns=self.anchor_collapse))
        return self._anchor_tab[2]

    def _refresh_anchor_tab(self):
        """The anchor table of the grid refresh (None: the exact chain)."""
        if self.anchor_cache and _use_frames(self.ccfg, self.mode):
            return self._anchor_table()
        return None

    def _get_near_cells(self) -> torch.Tensor:
        """The refresh's near-surface cells, computed once per template
        mesh, imported mesh or points and mode: the flat canvas's z = 0
        slab in mode 'field', the cells near the imported mesh or points
        in modes 'shape', 'unhash' and 'patch', else near the template (a
        cKDTree query over every cell centre)."""
        fs = self.field_state
        if self._near_cells is not None:
            (p, p_imp, mode), ids = self._near_cells
            if (p is fs.projector and p_imp is fs.projector_imported
                    and mode == self.mode):
                return ids
        if self.mode == "field":
            ids = canvas_near_cells(self.rcfg.grid_size, self.rcfg.bound,
                                    self.ccfg.field.h_threshold)
        else:
            arr = (fs.projector_imported
                   if self.mode in ("shape", "unhash", "patch")
                   else fs.projector)
            ids = compute_near_cells(arr.vertices.cpu().numpy(),
                                     self.rcfg.grid_size, self.rcfg.bound,
                                     self.ccfg.field.h_threshold)
        ids = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        self._near_cells = ((fs.projector, fs.projector_imported,
                             self.mode), ids)
        return ids

    def _infer_params(self, params):
        """Inference params of ``params`` (the params or their EMA), made
        once per parameter version: the tables are copies, and a step
        updates the params in place."""
        step = self.state.step
        for p, s, infer in self._infer:
            if p is params and s == step:
                return infer
        infer = curved_infer_params(params, self.ccfg)
        self._infer = [e for e in self._infer
                       if e[0] is not params and e[1] == step]
        self._infer.append((params, step, infer))
        return infer

    def _refresh(self):
        """One density-grid refresh over the near cells, reading the
        current params through their inference tables."""
        near = self._get_near_cells()
        draws = occ_mod.sparse_draws(
            self.generator, near.shape[0], grid_size=self.rcfg.grid_size,
            cascades=self.rcfg.cascades, bound=self.rcfg.bound)
        state = dataclasses.replace(
            self.state, params=self._infer_params(self.state.params))
        curved_grid_step(state, self.field_state, draws, ccfg=self.ccfg,
                         rcfg=self.rcfg, mode=self.mode, rt=self.runtime,
                         near_cells=near,
                         anchor_tab=self._refresh_anchor_tab())
        self.state.occ = state.occ

    def initialize_states(self, n: int = 50):
        """n density-grid refreshes (after an import, or of seeded or
        converted params).  Unlike the JAX trainer, which recomputes the
        near cells at every call, they are kept per template mesh,
        imported points and mode."""
        for _ in range(n):
            self._refresh()

    @torch.no_grad()
    def bake_atlas(self, *, use_ema: bool = False, T: int = 16,
                   max_bytes: float = 8e9):
        """The baked feature atlas of the params (or their EMA) over the
        current grid, and its extended anchor table: (``BakedAtlas``,
        [H^3, 24]).  Built once per parameter version, grid and T (the
        last two kept): #tiles x T^2 texels through the encode, in chunks
        of 262,144 texels."""
        fcfg = self.ccfg.field
        if fcfg.encoder_type != "hash" or self.mode != "none":
            raise ValueError("bake_atlas: hash encoder + mode 'none' only")
        if not self.anchor_collapse:
            raise ValueError("bake_atlas needs anchor_collapse=True "
                             "(one chart per surface cell)")
        params = self.state.ema_params if use_ema else self.state.params
        occ, step = self.state.occ, self.state.step
        for p, s, o, t, atlas, ext in self._bake:
            if p is params and s == step and o is occ and t == T:
                return atlas, ext
        C = fcfg.encoder_f_out_dim + (
            fcfg.normal_cfg.phi_embed_dim if fcfg.pred_normal else 0)
        enc = params["field"]["encoder"]
        nrm = params["field"].get("normal")
        tab = self._anchor_table()
        atlas = baked_mod.bake_atlas(
            lambda pts: _bake_encode_chunk(enc, nrm, pts, fcfg), tab,
            occ.occ, self.rcfg.grid_size, self.rcfg.bound, T=T,
            n_channels=C, chunk_tiles=max(1, 262144 // (T * T)),
            max_bytes=max_bytes)
        ext = baked_mod.extend_anchor_table(tab, atlas.tile_of_cell,
                                            atlas.anchors)
        self._bake = self._bake[-1:] + [(params, step, occ, T, atlas, ext)]
        return atlas, ext

    def _prepass_for(self, rcfg: RenderConfig) -> PrepassState:
        """The grid's PrepassState under ``rcfg`` (the live and the
        parity render each have their own), built once per occupancy
        grid and config."""
        occ = self.state.occ
        if self._prepass_occ is not occ:
            self._prepass = {}
            self._prepass_occ = occ
        if rcfg not in self._prepass:
            self._prepass[rcfg] = PrepassState.build(occ.occ, rcfg,
                                                     density=occ.density)
        return self._prepass[rcfg]

    @torch.no_grad()
    def render_frame(self, pose, *, use_ema: bool = True, bg_color=1.0,
                     H=None, W=None, parity: bool = False,
                     baked: bool = False, plain_select: bool = False):
        """Render one view.

        The live render takes ``rcfg`` as it is (the proxy path);
        ``parity=True`` renders the reference-exact sampling path --
        ``infer_mode='pool'`` with the shading cap raised to at least 16
        (a proxy-tuned cap would fill with leading haze in pool mode).
        ``baked=True`` (without ``parity``) renders the live path through
        the baked atlas of these params (``bake_atlas``); it needs mode
        'none', RGB, the hash encoder and the collapsed anchor table, and
        without them warns and renders the live field.
        ``plain_select`` runs the plain selection in place of the kernel.

        Returns dict(image [H, W, 3], depth, weights_sum, live, chunks)."""
        params = self.state.ema_params if use_ema else self.state.params
        static = (self.ccfg, self.mode, self.visual_mode,
                  self.light_visual_mode)
        bundle = {"params": self._infer_params(params),
                  "field_state": self.field_state, "rt": self.runtime}
        rcfg = self.rcfg
        use_frames = _use_frames(self.ccfg, self.mode)
        if parity:
            rcfg = dataclasses.replace(
                rcfg, infer_mode="pool",
                infer_color_cap=max(rcfg.infer_color_cap, 16))
        if use_frames and self.anchor_cache:
            bundle["anchor_tab"] = self._anchor_table()
        elif rcfg.anchor_per_sample:
            # no table: per-sample kNN would be the expensive chain, so
            # anchor once per ray
            rcfg = dataclasses.replace(rcfg, anchor_per_sample=False)
        if baked and not parity:
            if not (use_frames and self.anchor_cache and self.anchor_collapse
                    and self.visual_mode == "RGB"):
                warnings.warn("baked rendering needs mode 'none' + RGB + "
                              "hash encoder + collapsed anchor table; "
                              "falling back to the live field",
                              stacklevel=2)
            elif rcfg.deferred:
                raise NotImplementedError(
                    "CurvedTrainer.render_frame: deferred shading of the "
                    "baked atlas is not ported; ROADMAP Queue 1, item 12")
            else:
                bundle["bake"], bundle["anchor_ext"] = self.bake_atlas(
                    use_ema=use_ema)
                return render_image(
                    curved_field_apply_baked, static, bundle,
                    self._prepass_for(rcfg), pose, self.dataset.intrinsics,
                    H or self.H, W or self.W, rcfg, bg_color=bg_color,
                    anchor_apply=curved_anchor_apply_baked,
                    plain_select=plain_select)
        return render_image(
            curved_field_apply, static, bundle, self._prepass_for(rcfg),
            pose, self.dataset.intrinsics, H or self.H, W or self.W, rcfg,
            bg_color=bg_color,
            anchor_apply=curved_anchor_apply if use_frames else None,
            sigma_apply=curved_sigma_apply,
            color_apply=(curved_color_apply
                         if use_frames and self.visual_mode != "Grad"
                         else None),
            plain_select=plain_select)

    def eval_psnr(self, frame_indices=None, *, use_ema: bool = True,
                  parity: bool = False) -> float:
        """Mean PSNR of the given training frames (white background)."""
        vals = []
        for idx in frame_indices if frame_indices is not None else [0]:
            out = self.render_frame(np.asarray(self.dataset.poses[idx]),
                                    use_ema=use_ema, parity=parity)
            gt = np.asarray(self.dataset.images[idx]).astype(
                np.float32) / 255.0
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
            vals.append(psnr(out["image"], gt))
        return float(np.mean(vals))
