"""MeshFeatureField: the NeRF-Texture surface field (port of
``nerf_texture_tpu/models/mesh_field.py``).

A point x maps to (surface-feature embedding || height embedding, coarse
normal, fine normal, shell mask).  The import ``mode`` picks where the
features come from:

- 'none', the trained field: the surface near x is the tangent plane of
  x's anchor frame (p0, normal n, tbn, hit; see ``geometry.projector``),
  h = (x - p0) . n is the signed height and p_sur = x - h n the surface
  point; without frames, ``projector.project`` projects x exactly.  The
  packed hash grid encodes p_sur and the frequency encoding encodes h.
  With the probabilistic model the table is dual (feature mean +
  log-variance per brick row) and, outside inference, the features get
  reparameterised noise; the noise is an argument here (the JAX function
  draws it from its key), so that a test can hand the port JAX's draw;
- 'field', a synthesised flat canvas on the z = 0 plane: the features,
  phi embedding and TBN frames are sampled from [H, W, C] images at
  (x / bounds_x, y / bounds_y), the height is z;
- 'patch', one exported patch as a point cloud: the kNN-weighted
  projection onto its points blends their features;
- 'shape', a flat canvas wrapped onto another mesh (the imported
  projector) through its UVs: ``uvh`` gives (u, v, height), the canvas
  images are sampled at (u, v) and the height is scaled by the runtime's
  ``sdf_scale_factor``.  The phi and TBN images are those of the last
  'field' import (``field_io.load_field``), which this mode needs;
- 'unhash', features baked at the vertices of the imported mesh: the
  hit face of the projection along the base mesh's kNN normal blends its
  vertices' features by barycentrics (vertex ids past the features are
  clamped, as the JAX gather clamps them).

The fine normal is the normal net's, rotated by the local TBN, on a
canvas by the inverse of the sample TBN the texel was exported with,
and in mode 'shape' by the target face's TBN.  The regularisers
(clustering, KL) read the table's feature lanes.

With ``encoder_type='vertex'`` the features live on the vertices of a
subdivided copy of the template (``make_feature_projector``, the
state's ``projector_fea``): in mode 'none' each sample is projected
exactly (no anchor frames) and the hit face of the feature mesh, cast
along the detached coarse normal (``barycentric_mapping``), blends its
vertices' features; tanh and a frequency encoding make the embedding
(the import modes encode their features the same way).  The progressive
schedule grows the feature mesh level by level (``levels_vnum``,
``grow_feature_mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..geometry import projector as proj
from ..geometry.projector import MeshProjector, ProjectorArrays
from ..ops.encoding import freq_encode, freq_encode_dim
from ..ops.hashgrid_packed import (PackedGridSpec, packed_encode_bound,
                                   packed_encode_bound_dual)
from ..utils.grid_sample import grid_sample_2d
from . import clustering as clus
from . import normal_net


@dataclasses.dataclass(frozen=True)
class MeshFieldConfig:
    """Every field of the JAX MeshFieldConfig, so configurations convert;
    see the JAX module for what each one does."""

    num_levels: int = 8
    level_dim: int = 2
    base_resolution: int = 512
    desired_resolution: int = 1024
    log2_bricks: int = 16
    infer_table_bf16: bool = True
    train_table_bf16: bool = True
    h_threshold: float = 0.1
    k: int = 8
    k_for_uv: int = 5
    bound: float = 1.0
    clustering: bool = True
    prob_model: bool = True
    logvar_init: float = -8.0
    pred_normal: bool = True
    lip: bool = True
    pattern_rate: float = 1 / 50
    z_multires: int = 12
    bound_output_normal: bool = False
    n_clusters: int = 4
    per_ray_projection: bool = True
    encoder_type: str = "hash"
    feature_dim: int = 16
    vertex_multires: int = 8
    n_feature_vertices: int = 0
    level_num: int = 1
    base_vnum: int = 4096
    target_vnum: int = 128 ** 2

    @property
    def feature_spec(self) -> PackedGridSpec:
        return PackedGridSpec(
            input_dim=3, num_levels=self.num_levels,
            level_dim=self.level_dim,
            base_resolution=self.base_resolution,
            desired_resolution=self.desired_resolution,
            log2_bricks=self.log2_bricks, align_corners=True)

    @property
    def encoder_f_out_dim(self) -> int:
        if self.encoder_type == "vertex":
            return freq_encode_dim(self.feature_dim, self.vertex_multires)
        return self.num_levels * self.level_dim

    @property
    def encoder_z_out_dim(self) -> int:
        return freq_encode_dim(1, self.z_multires)

    @property
    def embed_dim(self) -> int:
        return self.encoder_f_out_dim + self.encoder_z_out_dim

    @property
    def normal_cfg(self) -> normal_net.NormalNetConfig:
        return normal_net.NormalNetConfig(
            x_dim=self.encoder_f_out_dim, z_dim=self.encoder_z_out_dim,
            lip=self.lip, bound_output=self.bound_output_normal,
            bound=self.bound)


class FieldRuntime(NamedTuple):
    """Interactive scalars (viewer sliders)."""

    sdf_scale_factor: float
    sdf_offset: float
    uv_utilize_rate: float
    fc_weight: float | None = None   # fine/coarse normal blend

    @staticmethod
    def default() -> "FieldRuntime":
        return FieldRuntime(sdf_scale_factor=1.0, sdf_offset=0.0,
                            uv_utilize_rate=1.0, fc_weight=1.0)


class ImportedData(NamedTuple):
    """Tensors of the import modes (size-1 placeholders when unused)."""

    features_2d: torch.Tensor       # [H, W, C] synthesised canvas
    phi_embed_2d: torch.Tensor      # [H, W, P]
    local_tbn_2d: torch.Tensor      # [H, W, 9]
    sample_tbn_ids_2d: torch.Tensor  # [H, W] int64
    sample_tbn_inv: torch.Tensor    # [S, 3, 3]
    bounds: torch.Tensor            # [2]
    features_v: torch.Tensor        # [V, C] per-point features
    phi_embed_v: torch.Tensor       # [V, P]
    local_tbn_v: torch.Tensor       # [V, 3, 3]

    @staticmethod
    def empty(device: torch.device | str = "cuda") -> "ImportedData":
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        eye = torch.eye(3, device=device)[None]
        return ImportedData(z(1, 1, 1), z(1, 1, 1), z(1, 1, 9),
                            z(1, 1, dtype=torch.int64), eye,
                            torch.ones((2,), device=device), z(1, 1),
                            z(1, 1), eye)


class MeshFieldState(NamedTuple):
    projector: ProjectorArrays            # base / template mesh
    projector_imported: ProjectorArrays   # imported mesh (or base copy)
    imported: ImportedData
    projector_fea: ProjectorArrays | None = None


def make_state(mesh_projector: MeshProjector,
               imported_projector: MeshProjector | None = None,
               imported: ImportedData | None = None,
               fea_projector: MeshProjector | None = None
               ) -> MeshFieldState:
    """The field's geometry state, on the projector's device."""
    return MeshFieldState(
        projector=mesh_projector.arrays,
        projector_imported=(imported_projector.arrays
                            if imported_projector is not None
                            else mesh_projector.arrays),
        imported=(imported if imported is not None
                  else ImportedData.empty(mesh_projector.device)),
        projector_fea=(fea_projector.arrays
                       if fea_projector is not None else None))


def make_feature_projector(mesh, min_vertices: int = 128 ** 2, *,
                           device: torch.device | str = "cuda"
                           ) -> MeshProjector:
    """The vertex encoder's feature mesh: the template subdivided until it
    has >= min_vertices, indexed without UVs."""
    from ..geometry.shape_tools import subdivide_to

    return MeshProjector(subdivide_to(mesh, min_vertices), store_uv=False,
                         device=device)


def levels_vnum(cfg: MeshFieldConfig) -> tuple[int, ...]:
    """The progressive schedule's vertex counts: geometric from base_vnum
    to target_vnum over level_num levels (target_vnum alone for one)."""
    if cfg.level_num <= 1:
        return (cfg.target_vnum,)
    ts = np.linspace(0.0, np.log2(cfg.target_vnum / cfg.base_vnum),
                     cfg.level_num)
    return tuple(int(round(cfg.base_vnum * 2.0 ** t)) for t in ts)


def _lift_midpoints(feats: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Features of one midpoint subdivision: the old rows, then one row
    per edge, 0.5 (f_u + f_v), in the order ``shape_tools.subdivide``
    numbers the midpoints (faces in order, edges ab, bc, ca, each at its
    first occurrence)."""
    e = faces[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2)
    key = np.minimum(e[:, 0], e[:, 1]) * (len(feats) + 1) \
        + np.maximum(e[:, 0], e[:, 1])
    _, first = np.unique(key, return_index=True)
    uv = e[np.sort(first)]
    return np.vstack([feats, 0.5 * (feats[uv[:, 0]] + feats[uv[:, 1]])])


def grow_feature_mesh(params, ema_params, state: MeshFieldState,
                      cfg: MeshFieldConfig, target_vnum: int):
    """Advance the vertex-feature mesh to >= target_vnum vertices: the
    current feature mesh (its device vertices, as the JAX function reads
    them) subdivided, the features and their EMA lifted to the new
    vertices by edge-midpoint averaging (the barycentric resample of the
    new vertices, exact on the old surface; host numpy, as in JAX).
    Returns (features [V, C], ema features, new state, V) on the state's
    device; the caller swaps them into the params and sets
    n_feature_vertices."""
    from ..geometry.mesh import Mesh
    from ..geometry.shape_tools import subdivide

    old = state.projector_fea
    dev = old.vertices.device
    mesh = Mesh(old.vertices.cpu().numpy(), old.faces.cpu().numpy())
    feats = [params["features_v"].detach().cpu().numpy(),
             ema_params["features_v"].detach().cpu().numpy()]
    while len(mesh.vertices) < target_vnum:
        feats = [_lift_midpoints(f, mesh.faces) for f in feats]
        mesh = subdivide(mesh)
    new_proj = MeshProjector(mesh, store_uv=False, device=dev)
    features, ema_features = (torch.as_tensor(f, device=dev) for f in feats)
    return (features, ema_features,
            state._replace(projector_fea=new_proj.arrays),
            int(mesh.vertices.shape[0]))


def init(generator: torch.Generator, cfg: MeshFieldConfig) -> dict[str, Any]:
    """Seeded params on the generator's device: the hash encoder's table
    (dual with ``prob_model``: means U(-1e-4, 1e-4), log-variances
    logvar_init + U(-1e-5, 1e-5)) and its cluster centres, or the vertex
    encoder's ``features_v`` [n_feature_vertices, feature_dim]
    U(-1, 1) and its 16 cluster centres; the normal net."""
    if cfg.encoder_type == "vertex":
        if cfg.n_feature_vertices <= 0:
            raise ValueError("encoder_type='vertex' needs "
                             "n_feature_vertices (the feature-mesh vertex "
                             "count) set in MeshFieldConfig")
        u = torch.rand((cfg.n_feature_vertices, cfg.feature_dim),
                       generator=generator, device=generator.device)
        params: dict[str, Any] = {"features_v": u * 2.0 - 1.0}
        if cfg.clustering:
            params["clusters"] = clus.init_cluster_centers(
                generator, 1, 16, cfg.feature_dim)
    else:
        spec = cfg.feature_spec
        if cfg.prob_model:
            params = {"encoder": spec.init_dual(
                generator, std_a=1e-4, std_b=1e-5, mean_b=cfg.logvar_init)}
        else:
            params = {"encoder": spec.init(generator)}
        if cfg.clustering:
            params["clusters"] = clus.init_cluster_centers(
                generator, cfg.num_levels, cfg.n_clusters, cfg.level_dim)
    if cfg.pred_normal:
        params["normal"] = normal_net.init(generator, cfg.normal_cfg)
    return params


class FieldOutput(NamedTuple):
    embed: torch.Tensor           # [N, F + Z]
    normal_coarse: torch.Tensor   # [N, 3]
    normal_fine: torch.Tensor     # [N, 3] (coarse copy without pred_normal)
    h_mask: torch.Tensor          # [N] bool
    phi_embed: torch.Tensor | None = None
    theta: torch.Tensor | None = None
    phi: torch.Tensor | None = None


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-5)


def apply(params, state: MeshFieldState, x: torch.Tensor,
          cfg: MeshFieldConfig, rt: FieldRuntime | None = None, *,
          mode: str = "none", noise: torch.Tensor | None = None,
          no_noise: bool = False, requires_grad_xyz: bool = False,
          return_phi_embed: bool = False, return_rot_angles: bool = False,
          need_normals: bool = True, frames=None) -> FieldOutput:
    """Evaluate the field at x [N, 3] in [-bound, bound] in import mode
    ``mode`` ('none', 'field', 'patch', 'shape' or 'unhash').

    In mode 'none', through the anchor frames ``frames`` (dict p0 /
    normal / tbn / hit at sample granularity), or without them through
    the exact projection (``requires_grad_xyz``: its outputs carry
    ``diff_project``'s gradients into x; through frames, h and p_sur are
    closed-form in x).  Without ``no_noise`` and with ``prob_model`` the
    features get ``noise * exp(clamp(log_var, -20, 2))``, where noise
    [N, L * C] is a standard normal draw.  The hash table is read through
    bf16 rows (``infer_table_bf16`` without noise, ``train_table_bf16``
    with it); a bf16 inference table (``hashgrid_packed.inference_table``)
    is read as it is.  The vertex encoder has no noise and no anchor
    frames (``ValueError``): its features come from the feature mesh's
    hit face (``requires_grad_xyz`` carries that cast's gradient into x
    too).  The import modes read ``state.imported`` and have no noise;
    they compute the fine normal whatever ``need_normals`` says, as the
    JAX function does."""
    vertex = cfg.encoder_type == "vertex"

    def encode_imported(feats):
        # the vertex encoder's canvases and points hold raw features
        return (freq_encode(torch.tanh(feats), cfg.vertex_multires)
                if vertex else feats)

    if rt is None:
        rt = FieldRuntime.default()
    ncfg = cfg.normal_cfg
    imp = state.imported
    phi_embed = theta = phi_angle = normal_fine_local = None
    local_tbn = sample_tbn_inv = new_tbn = None
    if mode == "none":
        amp = cfg.infer_table_bf16 if no_noise else cfg.train_table_bf16
        if frames is not None:
            if vertex:
                raise ValueError(
                    "per_ray_projection is incompatible with "
                    "encoder_type='vertex' (barycentric feature lookup is "
                    "per sample)")
            n = frames["normal"].detach()
            p0 = frames["p0"].detach()
            sdf = torch.sum((x - p0) * n, dim=-1, keepdim=True)
            p_sur = x - sdf * n
            h_mask = (torch.abs(sdf[..., 0]) < cfg.h_threshold) \
                & frames["hit"]
            normal_coarse = n
            local_tbn = frames["tbn"]
        else:
            p_sur, sdf, h_mask, normal_coarse, local_tbn = proj.project(
                state.projector, x, k=cfg.k, h_threshold=cfg.h_threshold,
                requires_grad_xyz=requires_grad_xyz)
        if vertex:
            # the feature mesh's hit face along the detached coarse normal
            vertex_idx, bary, sdf, h_mask, _ = proj.barycentric_mapping(
                state.projector_fea, x, normal_coarse.detach(),
                h_threshold=cfg.h_threshold,
                requires_grad_xyz=requires_grad_xyz)
            feats = torch.sum(params["features_v"][vertex_idx]
                              * bary[..., None], dim=-2)
            x_embed = freq_encode(torch.tanh(feats), cfg.vertex_multires)
        elif cfg.prob_model and not no_noise:
            if noise is None:
                raise ValueError("mesh_field.apply: the probabilistic "
                                 "features need a noise draw (or "
                                 "no_noise=True)")
            x_embed, log_var = packed_encode_bound_dual(
                p_sur, params["encoder"], cfg.feature_spec, bound=cfg.bound,
                amp=amp)
            if noise.shape != log_var.shape:
                # a draw of another size would broadcast silently
                raise ValueError(f"mesh_field.apply: noise of shape "
                                 f"{tuple(noise.shape)} for features of "
                                 f"shape {tuple(log_var.shape)}")
            # the exponent is clamped: an untied log-variance lane drifting
            # high would overflow exp and NaN the frame
            x_embed = x_embed + noise * torch.exp(torch.clamp(log_var,
                                                              -20.0, 2.0))
        else:
            x_embed = packed_encode_bound(p_sur, params["encoder"],
                                          cfg.feature_spec, bound=cfg.bound,
                                          amp=amp)
        z_embed = freq_encode(sdf, cfg.z_multires)
        if cfg.pred_normal and need_normals:
            phi_embed = normal_net.phi_embedding(params["normal"], p_sur,
                                                 ncfg, amp=amp)
            if return_rot_angles:
                theta, phi_angle = normal_net.apply(
                    params["normal"], z_embed, x_embed, ncfg,
                    phi_embed=phi_embed, return_rot_angles=True)
    elif mode == "field":
        p_sur = torch.stack([x[..., 0] / imp.bounds[0],
                             x[..., 1] / imp.bounds[1]], dim=-1)
        sdf = x[..., 2:3] - rt.sdf_offset
        h_mask = (torch.abs(sdf[..., 0]) < cfg.h_threshold) \
            & torch.all(torch.abs(p_sur) <= 1.0, dim=-1)
        x_embed = encode_imported(grid_sample_2d(imp.features_2d, p_sur))
        z_embed = freq_encode(sdf, cfg.z_multires)
        normal_coarse = torch.zeros_like(x)
        normal_coarse[..., 2] = 1.0
        if cfg.pred_normal:
            tid = grid_sample_2d(
                imp.sample_tbn_ids_2d[..., None].to(torch.float32), p_sur,
                mode="nearest")[..., 0].to(torch.int64)
            sample_tbn_inv = imp.sample_tbn_inv[tid]
            local_tbn = grid_sample_2d(imp.local_tbn_2d, p_sur,
                                       mode="nearest").reshape(-1, 3, 3)
            phi_embed = grid_sample_2d(imp.phi_embed_2d, p_sur)
    elif mode == "patch":
        sdf, idx, weights, normal_coarse, dis = proj.weighted_project(
            state.projector_imported, x, k=8, direct_above_check=True,
            direct_above_threshold=1.0)
        x_embed = encode_imported(torch.sum(
            weights[..., None] * imp.features_v[idx], dim=-2))
        z_embed = freq_encode(sdf, cfg.z_multires)
        h_mask = (torch.abs(sdf[..., 0]) < cfg.h_threshold) \
            & (torch.amin(dis, dim=-1) < cfg.h_threshold)
        if cfg.pred_normal:
            phi_embed = torch.sum(weights[..., None] * imp.phi_embed_v[idx],
                                  dim=-2)
            local_tbn = torch.sum(weights[..., None, None]
                                  * imp.local_tbn_v[idx], dim=-3)
    elif mode == "shape":
        if imp.features_2d.shape[-1] != (cfg.feature_dim if vertex else
                                         cfg.encoder_f_out_dim) or (
                cfg.pred_normal
                and imp.phi_embed_2d.shape[-1] != ncfg.phi_embed_dim):
            # the JAX function fails inside the normal net with a
            # dot_general shape error here
            raise ValueError(
                "mesh_field.apply: mode 'shape' reads the canvas images "
                "(features, phi embedding, TBN) of a 'field' import; call "
                "field_io.load_field before load_shape / load_unhash")
        uvh_out, h_mask, normal_coarse, new_tbn = proj.uvh(
            state.projector_imported, x, k=cfg.k_for_uv,
            h_threshold=cfg.h_threshold, sdf_scale=1.0, sdf_offset=0.0,
            requires_grad_xyz=requires_grad_xyz)
        # runtime sdf scaling; a tensor divisor divides exactly on CUDA
        scale = torch.tensor(max(rt.sdf_scale_factor / rt.uv_utilize_rate,
                                 1e-5), dtype=x.dtype, device=x.device)
        sdf = uvh_out[..., 2:3] / scale - rt.sdf_offset
        p_sur = uvh_out[..., :2] * rt.uv_utilize_rate
        x_embed = encode_imported(grid_sample_2d(imp.features_2d, p_sur))
        z_embed = freq_encode(sdf, cfg.z_multires)
        if cfg.pred_normal:
            tid = grid_sample_2d(
                imp.sample_tbn_ids_2d[..., None].to(torch.float32), p_sur,
                mode="nearest")[..., 0].to(torch.int64)
            sample_tbn_inv = imp.sample_tbn_inv[tid]
            local_tbn = grid_sample_2d(imp.local_tbn_2d, p_sur,
                                       mode="nearest").reshape(-1, 3, 3)
            phi_embed = grid_sample_2d(imp.phi_embed_2d, p_sur)
    elif mode == "unhash":
        normal_coarse, _, _, _ = proj.knn_normal(state.projector, x,
                                                 k=cfg.k)
        vertex_idx, bary, sdf, h_mask, _ = proj.barycentric_mapping(
            state.projector_imported, x, normal_coarse,
            h_threshold=cfg.h_threshold,
            requires_grad_xyz=requires_grad_xyz)
        scale = torch.tensor(max(rt.sdf_scale_factor, 1e-5), dtype=x.dtype,
                             device=x.device)
        sdf = sdf / scale - rt.sdf_offset
        # ids past the features are clamped, as the JAX gather clamps
        # them: ``field_io.unhash`` bakes the features in the subdivided
        # mesh's vertex order, but the imported projector renumbers the
        # vertices through its UV atlas (a reference quirk, ROADMAP
        # Queue 3)
        vertex_idx = torch.clamp(vertex_idx, max=imp.features_v.shape[0] - 1)
        x_embed = encode_imported(torch.sum(
            imp.features_v[vertex_idx] * bary[..., None], dim=-2))
        z_embed = freq_encode(sdf, cfg.z_multires)
        if cfg.pred_normal:
            phi_embed = torch.sum(imp.phi_embed_v[vertex_idx]
                                  * bary[..., None], dim=-2)
    else:
        raise ValueError(f"unknown import mode {mode}")
    if phi_embed is not None:
        normal_fine_local = normal_net.apply(params["normal"], z_embed,
                                             x_embed, ncfg,
                                             phi_embed=phi_embed)
    embed = torch.cat([x_embed, z_embed], dim=-1)
    normal_coarse = _normalize(normal_coarse)
    if normal_fine_local is not None:
        # TBN re-orientation chain: local, the inverse sample TBN, the
        # target face's TBN
        normal_fine = normal_fine_local
        for tbn in (local_tbn, sample_tbn_inv, new_tbn):
            if tbn is not None:
                normal_fine = torch.einsum("nba,nb->na", tbn, normal_fine)
        normal_fine = _normalize(normal_fine)
    else:
        normal_fine = normal_coarse
    return FieldOutput(embed=embed, normal_coarse=normal_coarse,
                       normal_fine=normal_fine, h_mask=h_mask,
                       phi_embed=phi_embed if return_phi_embed else None,
                       theta=theta, phi=phi_angle)


def clustering_loss(params, cfg: MeshFieldConfig, level: int | None = None):
    """The clustering regulariser over the hash table's feature lanes:
    level ``level`` (the JAX function's random pick), or every level
    summed; over the raw vertex features with the vertex encoder (no
    level); 0.0 without ``clustering``."""
    if not cfg.clustering:
        return 0.0
    if cfg.encoder_type == "vertex":
        return clus.clustering_loss_level(params["features_v"],
                                          params["clusters"][0])
    spec = cfg.feature_spec
    slices = [(spec.offsets[i], spec.offsets[i + 1])
              for i in range(cfg.num_levels)]
    return clus.clustering_loss(params["encoder"], slices, params["clusters"],
                                level=level, level_dim=cfg.level_dim,
                                row_width=spec.row_width)


def kl_loss(params, cfg: MeshFieldConfig, normal: bool = False):
    """VAE prior on the probabilistic features: over the dual table's
    log-variance lanes [rw, 2 rw) (and with ``normal`` the means [0, rw)
    too); the padding lanes beyond 2 rw are never read; 0.0 for the
    vertex encoder.  Not part of the training loss (as in the JAX
    package)."""
    if not cfg.prob_model or cfg.encoder_type != "hash":
        return 0.0
    rw = cfg.feature_spec.row_width
    f_var = params["encoder"][:, rw:2 * rw]
    if normal:
        f_mu = params["encoder"][:, :rw]
        return 0.5 * torch.sum(torch.exp(f_var) + f_mu ** 2 - 1.0 - f_var)
    return 0.5 * torch.sum(torch.exp(f_var) - 1.0 - f_var)


def regular_loss(params, cfg: MeshFieldConfig, level: int | None = None):
    """The field's regulariser in the training loss: 1e-8 x clustering."""
    return 1e-8 * clustering_loss(params, cfg, level)


# ---------------------------------------------------------------------------
# import constructors (host numpy in, tensors on ``device`` out)
# ---------------------------------------------------------------------------

def import_field_data(features, sample_tbn, sample_tbn_ids, local_tbn,
                      phi_embed, bounds, *,
                      device: torch.device | str = "cuda") -> ImportedData:
    """A synthesised flat canvas: features / phi_embed [H, W, C],
    local_tbn [H, W, 9], sample_tbn [S, 9] (inverted here, in f64),
    sample_tbn_ids [H, W], bounds [2] the canvas's world half-extents."""
    inv = np.linalg.inv(np.asarray(sample_tbn).reshape(-1, 3, 3))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    local_tbn = np.asarray(local_tbn)
    return ImportedData.empty(device)._replace(
        features_2d=f32(features), phi_embed_2d=f32(phi_embed),
        local_tbn_2d=f32(local_tbn.reshape(*local_tbn.shape[:2], 9)),
        sample_tbn_ids_2d=torch.as_tensor(
            np.asarray(sample_tbn_ids, np.int64), device=device),
        sample_tbn_inv=f32(inv), bounds=f32(bounds))


def import_patch_data(features, local_tbn, phi_embed, *,
                      device: torch.device | str = "cuda") -> ImportedData:
    """One exported patch as scattered points: features [V, C], local_tbn
    [V, 9], phi_embed [V, P]."""
    return ImportedData.empty(device)._replace(
        features_v=torch.as_tensor(np.asarray(features, np.float32),
                                   device=device),
        phi_embed_v=torch.as_tensor(np.asarray(phi_embed, np.float32),
                                    device=device),
        local_tbn_v=torch.as_tensor(
            np.asarray(local_tbn, np.float32).reshape(-1, 3, 3),
            device=device))


def import_unhash_data(features, phi_embed=None, *,
                       device: torch.device | str = "cuda") -> ImportedData:
    """Per-vertex features [V, C] (and phi embeddings [V, P], zeros
    [V, 1] without) baked onto a mesh."""
    phi = phi_embed if phi_embed is not None else np.zeros((len(features),
                                                            1))
    return ImportedData.empty(device)._replace(
        features_v=torch.as_tensor(np.asarray(features, np.float32),
                                   device=device),
        phi_embed_v=torch.as_tensor(np.asarray(phi, np.float32),
                                    device=device))
