"""Serving of the NeRF-Texture curved-field model (port of the inference
half of ``nerf_texture_tpu/train/curved_trainer.py``).

``CurvedTrainer`` holds a curved model over its template mesh and renders
it:

  initialize_states(n): n density-grid refreshes over the near-surface
    cells, each point anchored through the per-cell anchor table;
  render_frame(pose): the live proxy render -- block prepass, proxy
    sweep over the density grid, ``proxy_select_cdf`` placing the
    survivors, the curved field on the survivors, exact composite;
  render_frame(pose, parity=True): the pool render -- occupancy march,
    compacted pool, sigma over the pool, ``survivor_pool``, colour on
    the survivors;
  eval_psnr(frames): PSNR of the training views.

The JAX trainer's ``lru``/``id()`` caches become explicit state here: the
anchor table is built once per template mesh, the inference tables
(bf16 copies of the hash grids) once per parameter set, and a
``PrepassState`` once per occupancy grid and render config (the live
and the parity render each have one).  The random
draws of a refresh (the jitter of each cell) come from the trainer's
``torch.Generator`` through ``occupancy.sparse_draws``, or from the
caller of ``curved_grid_step``.

Not ported: training (``train`` raises, ROADMAP Queue 1, item 9), the
baked atlas render (``baked=True``, item 10), the import modes and the
flat-canvas near cells (item 11.2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..geometry import projector as proj
from ..models import curved_field
from ..models.curved_field import CurvedFieldConfig
from ..models.mesh_field import FieldRuntime, MeshFieldState
from ..ops import occupancy as occ_mod
from ..ops.hashgrid_packed import inference_table
from ..ops.occupancy import OccupancyGrid
from ..render.renderer import PrepassState, RenderConfig, render_image
from ..utils.metrics import psnr
from .trainer import TrainConfig


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
    """The model's state on one device (the optimizer state, step count
    and error map come with training, which is not ported)."""

    params: dict[str, Any]
    ema_params: dict[str, Any]
    occ: OccupancyGrid


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
    (``occupancy.sparse_draws``).  Each point anchors through
    ``anchor_tab`` (mode 'none', hash encoder); without the table the
    JAX function projects every point exactly, which is not ported
    (ROADMAP Queue 1, item 7).  Like the JAX function, the refresh decays
    the grid at ``update_host_sparse``'s default 0.95, not at
    ``TrainConfig.grid_decay``."""
    if anchor_tab is None or not _use_frames(ccfg, mode):
        raise NotImplementedError(
            "curved_grid_step: a refresh without the anchor table needs the "
            "exact per-sample projection, which is not ported; ROADMAP "
            "Queue 1, item 7")
    if near_cells is None:
        near_cells = compute_near_cells(
            field_state.projector.vertices.cpu().numpy(), rcfg.grid_size,
            rcfg.bound, ccfg.field.h_threshold)
    near_cells = torch.as_tensor(near_cells).to(
        device=state.occ.density.device, dtype=torch.int64)

    def chunk_fn(ids, noise, cas):
        return _curved_cell_sigma_anchored(
            state.params, field_state, rt, anchor_tab, ids, noise,
            ccfg=ccfg, rcfg=rcfg, mode=mode, cas=cas)

    state.occ = occ_mod.update_host_sparse(
        state.occ, chunk_fn, draws, near_cells, grid_size=rcfg.grid_size,
        cascades=rcfg.cascades, density_thresh=rcfg.density_thresh,
        chunk=262144)
    return state


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


def curved_infer_params(params, ccfg: CurvedFieldConfig):
    """Params whose hash grids are what inference reads: with
    ``infer_table_bf16`` the bf16 [rows, row_width] copies of the
    encoder table (its mean lanes) and of the phi grid, made once per
    parameter set."""
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


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.detach().clone()


class CurvedTrainer:
    """The curved model on one scene and template mesh.

    dataset: poses [B, 4, 4], images [B, H, W, C] uint8, intrinsics [4],
    H, W, num_frames (``data.synthetic.SyntheticSphereDataset``);
    field_state: ``mesh_field.make_state(MeshProjector(mesh,
    device=device))``.  The params are seeded from ``seed`` (or replaced
    through ``state``, e.g. by converted JAX params); everything lives on
    ``device``."""

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
        params = curved_field.init(self.generator, ccfg)
        self.state = CurvedTrainState(
            params=params, ema_params=_clone_tree(params),
            occ=occ_mod.create(rcfg.grid_size, rcfg.cascades,
                               device=self.device))
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
        self._near_cells = None          # (projector, mode, cell ids)
        self._infer = None               # (params, inference params)
        self._prepass_occ = None         # the grid the prepasses are of
        self._prepass: dict[RenderConfig, PrepassState] = {}

    def train(self, steps: int, log_every: int = 0):
        raise NotImplementedError(
            "CurvedTrainer.train: curved training is not ported yet; "
            "ROADMAP Queue 1, item 9")

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
        mesh and mode (a cKDTree query over every cell centre)."""
        p = self.field_state.projector
        if (self._near_cells is None or self._near_cells[0] is not p
                or self._near_cells[1] != self.mode):
            if self.mode != "none":
                raise NotImplementedError(
                    f"CurvedTrainer: the near cells of import mode "
                    f"{self.mode!r} are not ported; ROADMAP Queue 1, item "
                    f"11.2")
            ids = compute_near_cells(p.vertices.cpu().numpy(),
                                     self.rcfg.grid_size, self.rcfg.bound,
                                     self.ccfg.field.h_threshold)
            self._near_cells = (p, self.mode, torch.as_tensor(
                ids, dtype=torch.int64, device=self.device))
        return self._near_cells[2]

    def _infer_params(self, params):
        """Inference params of ``params``, made once per parameter set."""
        if self._infer is None or self._infer[0] is not params:
            self._infer = (params, curved_infer_params(params, self.ccfg))
        return self._infer[1]

    def initialize_states(self, n: int = 50):
        """n density-grid refreshes (after an import, or of seeded or
        converted params).  Unlike the JAX trainer, which recomputes the
        near cells at every call, they are kept per template mesh."""
        near = self._get_near_cells()
        for _ in range(n):
            draws = occ_mod.sparse_draws(
                self.generator, near.shape[0], grid_size=self.rcfg.grid_size,
                cascades=self.rcfg.cascades, bound=self.rcfg.bound)
            # the refresh reads the grids through the inference tables
            state = dataclasses.replace(
                self.state, params=self._infer_params(self.state.params))
            curved_grid_step(state, self.field_state, draws, ccfg=self.ccfg,
                             rcfg=self.rcfg, mode=self.mode, rt=self.runtime,
                             near_cells=near,
                             anchor_tab=self._refresh_anchor_tab())
            self.state.occ = state.occ

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
        ``plain_select`` runs the plain selection in place of the kernel.

        Returns dict(image [H, W, 3], depth, weights_sum, live, chunks)."""
        if baked and not parity:
            raise NotImplementedError(
                "CurvedTrainer.render_frame: the baked atlas render is not "
                "ported; ROADMAP Queue 1, item 10")
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
