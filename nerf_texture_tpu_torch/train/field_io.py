"""Field export, texture import and the mesh, point-cloud and image
exports (port of ``nerf_texture_tpu/train/field_io.py``).

- ``save_field`` samples texture patches from a trained curved field into
  a field npz;
- ``load_field`` imports a synthesised flat texture (``texture.npz``, see
  ``synthesis.quilting``; mode 'field'), ``load_patch`` one exported
  patch (mode 'patch');
- ``load_shape`` wraps that flat texture onto another mesh through its
  UVs, ``load_unhash`` imports a texture synthesised on another mesh
  (``curved_mesh.npz``, see ``synthesis.curved``; both mode 'shape',
  which reads the phi and TBN images of the last ``load_field``), and
  ``unhash`` bakes the trained hash field into the vertices of the
  subdivided template (mode 'unhash'); each import ends with the grid
  refresh of its mode;
- ``save_mesh`` writes the isosurface of a density (``ops.isosurface``),
  ``save_point_cloud`` the depth back-projection of rendered views,
  ``take_photo`` / ``render_train`` / ``render_round`` rendered frames as
  8-bit RGB PNG files (written with ``zlib``: no image library needed).

The npz files have the JAX package's schema, so a file written by one
package loads in the other.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from ..data.poses import orbit_pose
from ..geometry import projector as proj
from ..geometry.mesh import Mesh, save_obj, save_ply_points
from ..geometry.projector import MeshProjector, pointcloud_arrays
from ..geometry.shape_tools import normalize_mesh, subdivide_to
from ..models import mesh_field, normal_net
from ..ops.hashgrid_packed import packed_encode_bound
from ..synthesis.patches import PatchSampleConfig, sample_patches


def save_field(trainer, path: str, *, scan_pcl=None, mesh: Mesh = None,
               scfg: PatchSampleConfig | None = None, face_subset=None,
               stats: dict | None = None) -> dict:
    """Sample patches from the trainer's field (its params, not the EMA)
    on the host template ``mesh`` and write the field npz (entries that
    are None are left out).  ``face_subset`` restricts the patch centres
    to those faces; ``stats`` receives the candidate centres and rays
    cast (``sample_patches``).  Returns the export dict."""
    scfg = scfg or PatchSampleConfig()
    out = sample_patches(trainer.state.params["field"], trainer.field_state,
                         trainer.ccfg.field, mesh, scfg, scan_pcl=scan_pcl,
                         face_subset=face_subset, stats=stats)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: v for k, v in out.items() if v is not None})
    return out


def load_field(trainer, path: str):
    """Import a synthesised flat texture (texture.npz: features [H, W, C],
    grid_gap, sample_tbn, sample_tbn_ids, local_tbn, phi_embed) onto the
    z = 0 canvas of half-extents grid_gap * (H, W) / 2, switch the
    trainer to mode 'field' and refresh its grid (``initialize_states``'s
    50 refreshes)."""
    data = np.load(path, allow_pickle=True)
    features = data["features"]
    H, W = features.shape[:2]
    grid_gap = float(data["grid_gap"])
    imported = mesh_field.import_field_data(
        features=features, sample_tbn=data["sample_tbn"],
        sample_tbn_ids=data["sample_tbn_ids"],
        local_tbn=data["local_tbn"].reshape(H, W, 9),
        phi_embed=data["phi_embed"],
        bounds=[0.5 * grid_gap * H, 0.5 * grid_gap * W],
        device=trainer.device)
    trainer.field_state = trainer.field_state._replace(imported=imported)
    trainer.mode = "field"
    trainer.initialize_states()


def load_patch(trainer, field_npz_path: str, patch_id: int = 0):
    """Import patch ``patch_id`` (modulo the count) of a field npz as a
    scattered point field (its hits, with the patch normal), switch the
    trainer to mode 'patch' and refresh its grid (50 refreshes)."""
    data = np.load(field_npz_path, allow_pickle=True)
    pid = patch_id % data["patches"].shape[0]
    coors = data["patch_coors"][pid].reshape(-1, 3)
    norm = data["patch_norms"][pid]
    imported = mesh_field.import_patch_data(
        features=data["patches"][pid].reshape(-1,
                                              data["patches"].shape[-1]),
        local_tbn=data["patch_local_tbn"][pid].reshape(-1, 9),
        phi_embed=data["patch_phi_embed"][pid].reshape(
            -1, data["patch_phi_embed"].shape[-1]),
        device=trainer.device)
    pc = pointcloud_arrays(coors, np.tile(norm[None], (len(coors), 1)),
                           device=trainer.device)
    trainer.field_state = trainer.field_state._replace(
        imported=imported, projector_imported=pc)
    trainer.mode = "patch"
    trainer.initialize_states()


def load_shape(trainer, mesh: Mesh):
    """Wrap the last ``load_field``'s flat texture onto ``mesh``: the mesh
    is normalised (scale 1.2), gets a projector with a UV atlas, and the
    runtime's ``sdf_scale_factor`` becomes the projector's recommended
    factor over the canvas's half-extent; mode 'shape', then the grid
    refresh.  Returns the MeshProjector."""
    m = normalize_mesh(mesh, scale=1.2)
    mp = MeshProjector(m, device=trainer.device)
    rt = mesh_field.FieldRuntime.default()
    if mp.recommended_sdf_factor is not None:
        bounds = trainer.field_state.imported.bounds.cpu().numpy()
        rt = rt._replace(sdf_scale_factor=float(
            mp.recommended_sdf_factor / max(float(bounds[0]), 1e-9)))
    trainer.field_state = trainer.field_state._replace(
        projector_imported=mp.arrays)
    trainer.runtime = rt
    trainer.mode = "shape"
    trainer.initialize_states()
    return mp


def load_unhash(trainer, curved_npz_path: str, res: int = 1024):
    """Import a curved_mesh.npz (``synthesis.curved.synthesis_on_uvmap``):
    its mesh and uvs become the imported projector, its [1, C, H, W]
    canvas the features (per-vertex features [V, C] are baked into a
    res^2 UV canvas first, ``_bake_vertex_features``), its ``sdf_factor``
    the runtime's; mode 'shape', then the grid refresh.  Returns the
    MeshProjector."""
    data = np.load(curved_npz_path, allow_pickle=True)
    mesh = Mesh(data["mesh_vertices"], data["mesh_faces"],
                data["uv"] if "uv" in data else None)
    mp = MeshProjector(mesh, device=trainer.device)
    features = data["features"]
    if features.ndim == 4:                  # [1, C, H, W] canvas layout
        canvas = np.moveaxis(features[0], 0, -1)
    else:                                   # per-vertex features
        canvas = _bake_vertex_features(mp, features, res)
    imported = trainer.field_state.imported._replace(
        features_2d=torch.as_tensor(np.asarray(canvas, np.float32),
                                    device=trainer.device))
    trainer.field_state = trainer.field_state._replace(
        imported=imported, projector_imported=mp.arrays)
    trainer.runtime = mesh_field.FieldRuntime.default()._replace(
        sdf_scale_factor=float(data["sdf_factor"]))
    trainer.mode = "shape"
    trainer.initialize_states()
    return mp


@torch.no_grad()
def unhash(trainer, *, min_vertices: int = 100000):
    """Bake the trained hash field (the params, f32 tables) into the
    vertices of the template subdivided to ``min_vertices``: the feature
    encode and, with ``pred_normal``, the phi embedding at each vertex,
    65,536 vertices at a time; mode 'unhash', then the grid refresh.  The
    template is ``trainer.field_state_mesh`` if set, else the projector's
    arrays as a mesh.  Returns the MeshProjector of the fine mesh."""
    fine = subdivide_to(trainer.field_state_mesh
                        if hasattr(trainer, "field_state_mesh")
                        else _mesh_from_arrays(trainer.field_state.projector),
                        min_vertices)
    mp = MeshProjector(fine, device=trainer.device)
    fcfg = trainer.ccfg.field
    fparams = trainer.state.params["field"]
    verts = torch.as_tensor(np.asarray(fine.vertices, np.float32),
                            device=trainer.device)
    feats, phis = [], []
    for s0 in range(0, len(verts), 65536):
        v = verts[s0:s0 + 65536]
        feats.append(packed_encode_bound(
            v, fparams["encoder"], fcfg.feature_spec,
            bound=fcfg.bound).cpu().numpy())
        if fcfg.pred_normal:
            phis.append(normal_net.phi_embedding(
                fparams["normal"], v, fcfg.normal_cfg).cpu().numpy())
    features = np.concatenate(feats)
    phi = np.concatenate(phis) if phis else None
    trainer.field_state = trainer.field_state._replace(
        imported=mesh_field.import_unhash_data(features, phi,
                                               device=trainer.device),
        projector_imported=mp.arrays)
    trainer.mode = "unhash"
    trainer.initialize_states()
    return mp


def _mesh_from_arrays(arrays) -> Mesh:
    """The mesh of a projector's arrays (f32 vertices read as f64)."""
    return Mesh(arrays.vertices.cpu().numpy().astype(np.float64),
                arrays.faces.cpu().numpy().astype(np.int64))


@torch.no_grad()
def _bake_vertex_features(mp: MeshProjector, vert_features: np.ndarray,
                          res: int, batch: int = 65536) -> np.ndarray:
    """Bake per-vertex features [V, C] into a res^2 UV canvas: each texel
    of the UV plane takes the barycentric blend of its nearest face's
    vertices (zero where the UV plane is farther than 0.1)."""
    uvs = mp.arrays.uvs.cpu().numpy()
    plane = Mesh(np.concatenate([uvs, np.zeros((len(uvs), 1))], -1),
                 mp.mesh.faces)
    plane_proj = MeshProjector(plane, store_uv=False, device=mp.device)
    us, vs = np.meshgrid(np.linspace(-1, 1, res),
                         np.linspace(-1, 1, res), indexing="xy")
    texels = np.stack([us, vs, np.zeros_like(us)], -1).reshape(-1, 3)
    canvas = np.zeros((res * res, vert_features.shape[-1]), np.float32)
    vf = torch.as_tensor(np.asarray(vert_features, np.float32),
                         device=mp.device)
    for s in range(0, len(texels), batch):
        q = torch.as_tensor(texels[s:s + batch].astype(np.float32),
                            device=mp.device)
        sdf, fid, bary, _ = proj.signed_distance(plane_proj.arrays, q)
        vids = plane_proj.arrays.faces[torch.clamp(fid, min=0)]
        vals = torch.sum(vf[vids] * bary[..., None], dim=-2)
        vals = vals * (torch.abs(sdf)[:, None] < 0.1)
        canvas[s:s + batch] = vals.cpu().numpy()
    return canvas.reshape(res, res, -1)


# ---------------------------------------------------------------------------
# mesh / point cloud export
# ---------------------------------------------------------------------------

def save_mesh(density_fn, path: str, *, resolution: int = 256,
              bound: float = 1.0, threshold: float = 10.0,
              device: torch.device | str = "cuda"):
    """Write the ``density == threshold`` isosurface of ``density_fn``
    (points [n, 3] on ``device`` -> density [n]) over a resolution^3
    grid to an OBJ file; returns (vertices, faces)."""
    from ..ops.isosurface import extract_mesh

    v, f = extract_mesh(density_fn, resolution=resolution, bound=bound,
                        threshold=threshold, device=device)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_obj(path, Mesh(v, f))
    return v, f


@torch.no_grad()
def save_point_cloud(trainer, path: str, *, n_views: int = 12,
                     min_weight: float = 0.95, max_points: int = 200000,
                     seed: int = 0):
    """Write a scan point cloud (PLY): the depth of ``n_views`` training
    views picked by farthest-point order of their camera centres, back-
    projected where the composited weight exceeds ``min_weight``; at most
    ``max_points``, subsampled by ``np.random.default_rng(seed)``.
    Returns the points [n, 3]."""
    from ..data.rays import get_rays
    from ..ops.marching import near_far_from_aabb

    poses = trainer.poses.cpu().numpy()
    # farthest-pose subset
    centers = poses[:, :3, 3]
    chosen = [0]
    d2 = ((centers - centers[0]) ** 2).sum(-1)
    for _ in range(min(n_views, len(poses)) - 1):
        idx = int(np.argmax(d2))
        chosen.append(idx)
        d2 = np.minimum(d2, ((centers - centers[idx]) ** 2).sum(-1))

    b = trainer.rcfg.bound
    aabb = torch.tensor([-b] * 3 + [b] * 3, device=trainer.poses.device)
    pts = []
    for idx in chosen:
        out = trainer.render_frame(poses[idx], use_ema=False)
        depth = out["depth"].reshape(-1)
        wsum = out["weights_sum"].reshape(-1)
        rays = get_rays(trainer.poses[idx], trainer.intrinsics, trainer.H,
                        trainer.W)
        o, d = rays["rays_o"], rays["rays_d"]
        # depth is normalized (t - near) / (far - near); recover t
        nears, fars = near_far_from_aabb(o, d, aabb, trainer.rcfg.min_near)
        t = nears + depth * (fars - nears)
        mask = (wsum > min_weight) & (t > 0)
        pts.append((o + t[:, None] * d)[mask].cpu().numpy())
    pcl = np.concatenate(pts, 0)
    if len(pcl) > max_points:
        rng = np.random.default_rng(seed)
        pcl = pcl[rng.choice(len(pcl), max_points, replace=False)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_ply_points(path, pcl)
    return pcl


# ---------------------------------------------------------------------------
# offline renderers
# ---------------------------------------------------------------------------

def write_png(path: str, img: np.ndarray):
    """Write img [H, W, 3] (or [H, W, 4]) uint8 as an 8-bit RGB (RGBA)
    PNG: one IDAT chunk, filter type 0 on every row."""
    h, w, c = img.shape
    raw = b"".join(b"\x00" + row.tobytes()
                   for row in np.ascontiguousarray(img, np.uint8))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def take_photo(trainer, pose, *, H=None, W=None, path: str | None = None,
               bg_color=1.0):
    """Render ``pose`` (the EMA params, as the trainer's default) and
    return the image [H, W, 3] clipped to [0, 1]; with ``path`` also
    write it as an 8-bit PNG."""
    out = trainer.render_frame(pose, H=H, W=W, bg_color=bg_color)
    img = np.clip(out["image"].cpu().numpy(), 0, 1)
    if path:
        write_png(path, (img * 255).astype(np.uint8))
    return img


def render_train(trainer, out_dir: str, *, indices=None):
    """Render every (or the selected) training view to
    ``out_dir/train_<i>.png``; returns the paths."""
    poses = trainer.poses.cpu().numpy()
    indices = indices if indices is not None else range(len(poses))
    paths = []
    for i in indices:
        p = os.path.join(out_dir, f"train_{i:04d}.png")
        take_photo(trainer, poses[i], path=p)
        paths.append(p)
    return paths


def render_round(trainer, out_dir: str, *, n_frames: int = 30,
                 radius: float | None = None, theta: float = np.pi / 2.2):
    """Render ``n_frames`` views on an orbit at polar angle ``theta`` and
    ``radius`` (default: the training cameras' mean distance) to
    ``out_dir/round_<k>.png``; returns the paths."""
    radius = radius if radius is not None else float(
        np.linalg.norm(trainer.poses.cpu().numpy()[:, :3, 3],
                       axis=-1).mean())
    paths = []
    for k in range(n_frames):
        pose = orbit_pose(theta, 2 * np.pi * k / n_frames, radius)
        p = os.path.join(out_dir, f"round_{k:04d}.png")
        take_photo(trainer, pose, path=p)
        paths.append(p)
    return paths
