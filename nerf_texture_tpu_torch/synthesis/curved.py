"""Texture synthesis on a curved target surface (port of
``nerf_texture_tpu/synthesis/curved.py``, the TPAMI extension).

``uv2vert`` maps the target mesh's UV texels to 3D surface points (the
nearest-face query over the flattened UV-plane mesh);
``define_vector_field`` projects a constant direction into every vertex's
tangent plane; ``synthesis_on_uvmap`` then repeats: pick the next seed
texel by range voting over a sparse proxy (``SparseProxyDist``), cast a
patch grid onto the surface in the seed's frame
(``extract_patch_on_surface``: ray cast, ``uvh``, morphological mask
clean-up), read the synthesised context at the patch texels' uvs, match a
source patch (``MatchingLib``, or the plain masked L2), blend the border
and write the texels the patch covers (``_interp_on_grid``).  The output
is the ``curved_mesh.npz`` payload, which ``field_io.load_unhash`` reads.

The loop is sequential and stays on the host, as in the JAX package; the
queries run on the projector's device: ``uv2vert``'s nearest-face query,
each patch's ray cast and ``uvh``, and the two canvas reads of an
iteration (``grid_sample_2d`` of device copies of the canvases, updated
with the host writes).  Host numpy and cKDTree elsewhere, mirrored from
the JAX package statement for statement, with two changes that give the
same answers: ``SparseProxyDist`` keeps its range votes as int8 and
computes the distances of the pairs within the gap alone (the JAX class
keeps the float64 distance matrix and builds a [S, S, 3] temporary:
14.5 GB for a 24,578-vertex target), and
``extract_patch_on_surface`` queries the projector's cKDTree of the mesh
vertices (``MeshProjector.vertex_tree``, built once) rather than
building one at every call.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from scipy import ndimage
from scipy.spatial import cKDTree

from ..geometry import projector as proj
from ..geometry.mesh import Mesh
from ..geometry.projector import MeshProjector
from ..geometry.spatial import raycast
from ..utils.grid_sample import grid_sample_2d


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def pca_color_transform(data: np.ndarray, out_dim: int = 3):
    """A PCA mapping of the last axis onto ``out_dim`` components scaled
    into [0, 1] over ``data`` (the latent visualisation, and the matcher's
    channel compression)."""
    x = data.reshape(-1, data.shape[-1])
    mean = x.mean(0)
    _, _, vt = np.linalg.svd(x - mean, full_matrices=False)
    comp = vt[:out_dim]
    p = (x - mean) @ comp.T
    lo, hi = p.min(0), p.max(0)

    def f(a):
        q = (a.reshape(-1, a.shape[-1]) - mean) @ comp.T
        q = np.clip((q - lo) / (hi - lo + 1e-12), 0, 1)
        return q.reshape(*a.shape[:-1], out_dim)

    return f


def augment_patches(patches: np.ndarray, *, mirror_hor=True,
                    mirror_vert=True, crop_shift=True,
                    crop_factor: int = 2) -> np.ndarray:
    """Mirrors (x4) and shifted crops to 4/5 of the side (x crop_factor^2)
    of patches [N, P, P, C]."""
    out = patches
    if mirror_hor:
        out = np.concatenate([out, out[:, ::-1]], 0)
    if mirror_vert:
        out = np.concatenate([out, out[:, :, ::-1]], 0)
    if crop_shift:
        crop_out = out.shape[1] // 5
        crop_len = out.shape[1] - crop_out
        stride = max(crop_out // crop_factor, 1)
        offs = np.arange(crop_factor) * stride
        crops = [out[:, :crop_len, :crop_len]]
        for i in range(crop_factor):
            for j in range(crop_factor):
                if i == 0 and j == 0:
                    continue
                crops.append(out[:, offs[i]:crop_len + offs[i],
                                 offs[j]:crop_len + offs[j]])
        out = np.concatenate(crops, 0)
    return out


def define_vector_field(mesh: Mesh,
                        default=np.array([0.0, 1.0, 0.0])) -> np.ndarray:
    """A constant direction projected into each vertex's tangent plane."""
    n = mesh.vertex_normals
    v = default[None] - (n * default[None]).sum(-1, keepdims=True) * n
    return v


def resize_bilinear(img: np.ndarray, h: int, w: int, *,
                    device: torch.device | str = "cuda") -> np.ndarray:
    """Bilinear resize of img [H, W, C] (or a batch [B, H, W, C]) to
    [h, w] by ``grid_sample_2d`` on ``device`` (corners aligned, edges
    clamped), in f32.  A batch is sampled as one image of B x C channels:
    the same arithmetic for every element."""
    ys = np.linspace(-1, 1, h)
    xs = np.linspace(-1, 1, w)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    coords = torch.as_tensor(np.stack([gx, gy], -1).astype(np.float32),
                             device=device)
    a = torch.as_tensor(np.asarray(img, np.float32), device=device)
    batch = a.ndim == 4
    if batch:
        B, H, W, C = a.shape
        a = a.permute(1, 2, 0, 3).reshape(H, W, B * C)
    out = grid_sample_2d(a, coords, padding_zero=False).cpu().numpy()
    if batch:
        out = out.reshape(h, w, B, C).transpose(2, 0, 1, 3)
    return out


class MatchingLib:
    """Coarse-to-fine patch matcher: a pyramid of downsampled copies of
    the library; each level keeps the best 1/``pyramid_num_factor`` of
    the candidates by masked L2, the last level the best one."""

    def __init__(self, patches: np.ndarray, *, channel_pca_dim=None,
                 pyramid_height: int = 2, pyramid_num_factor: int = 10,
                 pyramid_size_factor: int = 8, quantize: bool = False,
                 device: torch.device | str = "cuda"):
        self.device = device
        self.channel_pca_dim = channel_pca_dim
        if channel_pca_dim is not None:
            self.compress = pca_color_transform(patches, channel_pca_dim)
            patches = self.compress(patches)
        else:
            self.compress = None
        self.levels = [patches]
        sizes = [patches.shape[1]]
        nums = [patches.shape[0]]
        for _ in range(pyramid_height - 1):
            psize = max(4, sizes[0] // pyramid_size_factor)
            nums.append(max(1, nums[-1] // pyramid_num_factor))
            small = resize_bilinear(self.levels[0], psize, psize,
                                    device=device)
            self.levels = [small] + self.levels
            sizes = [psize] + sizes
        self.sizes = sizes
        self.keep_nums = nums[1:] + [1]

    def match(self, condition: np.ndarray, mask: np.ndarray) -> int:
        if self.compress is not None:
            condition = self.compress(condition)
        conds = [condition]
        masks = [mask]
        for i in range(1, len(self.levels)):
            s = self.sizes[-i - 1]
            conds = [resize_bilinear(conds[0], s, s,
                                     device=self.device)] + conds
            masks = [(resize_bilinear(masks[0].astype(np.float32), s, s,
                                      device=self.device) > 0)] + masks
        indices = np.arange(len(self.levels[0]))
        for i, (lvl, cond, msk) in enumerate(zip(self.levels, conds,
                                                 masks)):
            err = (((cond[None] - lvl[indices]) * msk[None]) ** 2
                   ).reshape(len(indices), -1).sum(-1)
            k = min(self.keep_nums[i], len(indices))
            pick = np.argpartition(err, k - 1)[:k]
            indices = indices[pick]
        return int(indices[0])


class SparseProxyDist:
    """A coarse distance proxy over a sparse vertex subset, and the range
    voting that picks the next synthesis seed.

    ``set_range_vote(gap)`` turns the sparse-to-sparse distances into
    votes, +1 in the ring (0.8, 1) x gap and -1 inside 0.8 x gap, kept as
    int8; only the pairs a cKDTree finds within the gap get a distance,
    by the JAX class's formula, so the votes equal those of its float64
    matrix.  ``range_vote`` needs them."""

    def __init__(self, dense_verts: np.ndarray,
                 sparse_verts: np.ndarray | None = None,
                 preferred_patch_gap: float | None = None):
        self.dense = dense_verts
        if sparse_verts is None:
            vox = (preferred_patch_gap / 10 if preferred_patch_gap
                   else 0.05 * (dense_verts.max() - dense_verts.min()))
            sparse_verts = _voxel_downsample(dense_verts, vox)
        self.sparse = sparse_verts
        self.tree = cKDTree(sparse_verts)
        _, self.d2s = self.tree.query(dense_verts)
        self.votes = None
        nn, _ = self.tree.query(sparse_verts, k=min(2, len(sparse_verts)))
        self.sparse_avg = (nn[:, 1].mean() * 1.2 if nn.ndim > 1
                           else 1e-3)

    def set_range_vote(self, gap: float):
        s = self.sparse
        # the tree's radius is a little wider than the gap: its distances
        # may differ from numpy's in the last bits
        pairs = self.tree.query_pairs(gap * (1 + 1e-6), output_type="ndarray")
        diag = np.arange(len(s))
        i = np.concatenate([pairs[:, 0], pairs[:, 1], diag])
        j = np.concatenate([pairs[:, 1], pairs[:, 0], diag])
        d = np.linalg.norm(s[i] - s[j], axis=-1)
        votes = np.zeros((len(s), len(s)), np.int8)
        votes[i, j] = (np.logical_and(d < gap, d > 0.8 * gap).astype(np.int8)
                       - (d <= 0.8 * gap).astype(np.int8))
        self.votes = votes

    def range_vote(self, history_idx, done_mask) -> int:
        if self.votes is None:
            raise ValueError("SparseProxyDist.range_vote: call "
                             "set_range_vote(gap) first")
        hist_sparse = np.unique(self.d2s[history_idx])
        todo = np.where(~done_mask)[0]
        votes = self.votes[self.d2s[todo][:, None],
                           hist_sparse[None, :]].sum(1)
        return int(todo[np.argmax(votes)])

    def pick_vertices_to_set(self, tree_verts: np.ndarray,
                             grid_gap: float) -> np.ndarray:
        tree = cKDTree(tree_verts)
        d_sp, _ = tree.query(self.sparse)
        ok_sparse = np.where(d_sp < self.sparse_avg * 2)[0]
        cand = np.where(np.isin(self.d2s, ok_sparse))[0]
        if len(cand) == 0:
            return cand
        d, _ = tree.query(self.dense[cand])
        return cand[d < grid_gap]


def _voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    key = np.floor(points / max(voxel, 1e-9)).astype(np.int64)
    _, idx = np.unique(key, axis=0, return_index=True)
    return points[np.sort(idx)]


# ---------------------------------------------------------------------------
# UV rasterisation
# ---------------------------------------------------------------------------

def uv2vert(mesh_proj: MeshProjector, resolution: int = 512,
            batch: int = 65536):
    """The 3D surface point of every texel of a resolution^2 UV map: the
    nearest-face query over the UV-plane copy of the mesh (uvs in
    [-1, 1], z = 0), in batches of ``batch`` texels; a texel within 1e-2
    of the plane mesh is kept.  Returns (verts [K, 3] f32, flat texel ids
    [K], resolution)."""
    m = mesh_proj.mesh
    arr = mesh_proj.arrays
    uvs = arr.uvs.cpu().numpy()                              # [-1, 1]
    plane = Mesh(np.concatenate(
        [uvs, np.zeros((len(uvs), 1))], -1), m.faces)
    plane_proj = MeshProjector(plane, store_uv=False,
                               device=mesh_proj.device)

    us, vs = np.meshgrid(np.linspace(-1, 1, resolution),
                         np.linspace(-1, 1, resolution), indexing="xy")
    texels = np.stack([us, vs, np.zeros_like(us)],
                      -1).reshape(-1, 3).astype(np.float32)
    verts = np.zeros((len(texels), 3), np.float32)
    hit = np.zeros(len(texels), bool)
    for s in range(0, len(texels), batch):
        q = torch.as_tensor(texels[s:s + batch], device=mesh_proj.device)
        sdf, fid, bary, _ = proj.signed_distance(plane_proj.arrays, q)
        tri = arr.vertices[plane_proj.arrays.faces[torch.clamp(fid, min=0)]]
        v3d = torch.sum(tri * bary[..., None], dim=-2)
        verts[s:s + batch] = v3d.cpu().numpy()
        hit[s:s + batch] = np.abs(sdf.cpu().numpy()) < 1e-2
    ids = np.arange(resolution * resolution)
    return verts[hit], ids[hit], resolution


# ---------------------------------------------------------------------------
# patch extraction on the target surface
# ---------------------------------------------------------------------------

def extract_patch_on_surface(mesh_proj: MeshProjector, vert: np.ndarray,
                             patch_size: int, vectors: np.ndarray,
                             grid_gap: float,
                             shooting_distance: float = 0.05,
                             stats: dict | None = None):
    """Cast a patch_size^2 grid of spacing ``grid_gap`` onto the surface
    in the seed's frame (the nearest vertex's normal and the direction
    field), from ``shooting_distance`` above it.  A texel is kept where
    the cast hits a face facing within 45 degrees of the seed normal
    within 0.05 of the expected depth, then the mask is opened and
    closed.  Returns (verts [P, P, 3], uvs [P, P, 2], mask [P, P],
    faces of the patch grid [2 (P-1)^2, 3]).  ``stats['device_s']``
    accumulates the seconds of the ray cast and ``uvh``."""
    arr = mesh_proj.arrays
    dev = mesh_proj.device
    cal = np.linspace(-patch_size * grid_gap / 2,
                      patch_size * grid_gap / 2, patch_size)
    gx, gy = np.meshgrid(cal, cal, indexing="ij")
    local = np.stack([gx.ravel(), gy.ravel(),
                      np.zeros(patch_size ** 2)], -1)

    # seed frame from the nearest vertex normal + direction field
    _, vid = mesh_proj.vertex_tree.query(vert)
    z_axis = mesh_proj.mesh.vertex_normals[vid]
    y_axis = np.cross(z_axis, vectors[vid])
    if np.abs(y_axis).sum() < 1e-12:
        y_axis = np.cross(z_axis, np.array([1.0, 1.0, 1.01])
                          + vectors[vid])
    y_axis /= np.linalg.norm(y_axis)
    x_axis = np.cross(y_axis, z_axis)
    R = np.stack([x_axis, y_axis, z_axis], -1)
    origins = local @ R.T + vert + shooting_distance * z_axis
    dirs = np.broadcast_to(-z_axis[None], origins.shape)

    t0 = time.perf_counter()
    pos, _, depth, fid = raycast(
        arr.tgrid, arr.vertices, arr.faces,
        torch.as_tensor(np.asarray(origins, np.float32), device=dev),
        torch.as_tensor(np.asarray(dirs, np.float32), device=dev))
    depth = depth.cpu().numpy().reshape(patch_size, patch_size)
    fid_np = fid.cpu().numpy().reshape(patch_size, patch_size)
    uvh_out, _, _, _ = proj.uvh(arr, pos)
    uvs = uvh_out[:, :2].cpu().numpy().reshape(patch_size, patch_size, 2)
    verts3d = pos.cpu().numpy().reshape(patch_size, patch_size, 3)
    if stats is not None:
        stats["device_s"] = stats.get("device_s", 0.0) \
            + time.perf_counter() - t0
    mask = depth < 9.5
    # normal-angle check
    fnorm = np.asarray(mesh_proj.mesh.face_normals)[
        fid_np.clip(0).reshape(-1)].reshape(patch_size, patch_size, 3)
    mask &= (fnorm * z_axis).sum(-1) > np.cos(np.pi / 4)
    # depth check
    mask &= np.abs(depth - shooting_distance) < 0.05
    # morphology cleanup (open + close)
    mask = ndimage.binary_erosion(mask, iterations=2)
    mask = ndimage.binary_dilation(mask, iterations=4)
    mask = ndimage.binary_erosion(mask, iterations=2)

    vid_grid = np.arange(patch_size ** 2).reshape(patch_size, patch_size)
    faces = []
    for i in range(patch_size - 1):
        for j in range(patch_size - 1):
            faces.append([vid_grid[i, j], vid_grid[i + 1, j],
                          vid_grid[i, j + 1]])
            faces.append([vid_grid[i + 1, j], vid_grid[i + 1, j + 1],
                          vid_grid[i, j + 1]])
    return verts3d, uvs, mask, np.asarray(faces, np.int64)


# ---------------------------------------------------------------------------
# the synthesis loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CurvedSynthesisConfig:
    grid_gap: float = 5e-4
    resolution: int = 512
    use_matchlib: bool = True
    max_iters: int = 10000
    seed: int = 0


def synthesis_on_uvmap(mesh_proj: MeshProjector, verts: np.ndarray,
                       vert_ids: np.ndarray, resolution: int,
                       patches: np.ndarray, vectors: np.ndarray,
                       original_grid_gap: float,
                       cfg: CurvedSynthesisConfig,
                       progress: bool = False,
                       stats: dict | None = None) -> dict:
    """Synthesise ``patches`` [N, P, P, C] onto the UV map of
    ``mesh_proj``'s mesh (``verts`` / ``vert_ids`` from ``uv2vert``)
    until every texel is set or ``cfg.max_iters`` iterations.  Returns the
    curved_mesh.npz payload (features [1, C, R, R], the mesh and its uvs,
    sdf_factor = grid_gap / original_grid_gap).  ``stats`` receives
    ``iters``, ``total_s`` (the call), ``setup_s`` (added to: the range
    votes and the matcher's pyramid), ``loop_s`` (the iterations),
    ``device_s`` (their queries: ray cast, uvh and canvas reads, each
    ending in its host copy) and ``done`` (the share of texels set)."""
    t_start = time.perf_counter()
    st = stats if stats is not None else {}
    st["device_s"] = 0.0
    dev = mesh_proj.device
    C = patches.shape[-1]
    ps = patches.shape[1]
    textures = np.zeros((resolution, resolution, C), np.float32)
    syn_mask_img = np.zeros((resolution, resolution, 1), np.float32)
    # device copies of the canvases, written with the host's values
    tex_dev = torch.zeros((resolution, resolution, C), device=dev)
    mask_dev = torch.zeros((resolution, resolution, 1), device=dev)
    done = np.zeros(len(verts), bool)

    gap = cfg.grid_gap
    preferred = ps * gap * 0.9
    proxy = SparseProxyDist(verts, mesh_proj.mesh.vertices, preferred)
    proxy.set_range_vote(preferred)
    matcher = (MatchingLib(patches, device=dev) if cfg.use_matchlib
               else None)
    t_loop = time.perf_counter()
    st["setup_s"] = st.get("setup_s", 0.0) + t_loop - t_start

    history = [0]
    last = -1
    iters = 0
    smooth_range = max(ps // 20, 1)
    while not done.all() and iters < cfg.max_iters:
        iters += 1
        seed_id = proxy.range_vote(history, done)
        dead_loop = seed_id == last
        last = seed_id
        history.append(seed_id)

        p_verts, p_uvs, p_mask, p_faces = extract_patch_on_surface(
            mesh_proj, verts[seed_id], ps, vectors, gap, stats=st)
        t0 = time.perf_counter()
        uv_t = torch.as_tensor(p_uvs.reshape(-1, 2), device=dev)
        occupied = (grid_sample_2d(mask_dev, uv_t).cpu().numpy().reshape(
            ps, ps) > 0.9) & p_mask
        context = grid_sample_2d(tex_dev, uv_t).cpu().numpy().reshape(
            ps, ps, C)
        st["device_s"] += time.perf_counter() - t0

        # border blending mask: mean of progressively eroded occupancy
        blend_stack = [occupied.astype(np.float32)]
        for _ in range(smooth_range):
            blend_stack.append(ndimage.binary_erosion(
                blend_stack[-1] > 0).astype(np.float32))
        blend = np.stack(blend_stack).mean(0)[..., None]
        match_mask = occupied[..., None] - blend

        if matcher is not None:
            pid = matcher.match(context, match_mask)
        else:
            err = (((patches - context[None]) ** 2)
                   * match_mask[None]).reshape(len(patches), -1).sum(-1)
            pid = int(np.argmin(err))
        picked = patches[pid] * (1 - blend) + context * blend

        # vertices to set: inside the (eroded) un-occupied patch region
        er_occ = ndimage.binary_erosion(occupied)
        inner = (~er_occ & p_mask)[2:-2, 2:-2]
        tree_verts = p_verts[2:-2, 2:-2].reshape(-1, 3)[inner.ravel()]
        if len(tree_verts) == 0:
            tree_verts = verts[seed_id:seed_id + 1]
        to_set = proxy.pick_vertices_to_set(tree_verts, gap)
        to_set = np.union1d(to_set, [seed_id])

        # barycentric texel assignment on the patch grid
        pv_flat = p_verts.reshape(-1, 3)
        tree = cKDTree(pv_flat)
        d, nearest = tree.query(verts[to_set])
        thr = np.inf if dead_loop else max(1e-3, 2 * gap)
        ok = d < thr
        to_set = to_set[ok]
        if len(to_set):
            vals = _interp_on_grid(p_verts, picked, verts[to_set])
            rows = vert_ids[to_set] // resolution
            cols = vert_ids[to_set] % resolution
            textures[rows, cols] = vals
            syn_mask_img[rows, cols] = 1.0
            r_t = torch.as_tensor(rows, device=dev)
            c_t = torch.as_tensor(cols, device=dev)
            tex_dev[r_t, c_t] = torch.as_tensor(textures[rows, cols],
                                                device=dev)
            mask_dev[r_t, c_t] = 1.0
            done[to_set] = True
        done[seed_id] = True
        if progress and iters % 10 == 0:
            print(f"curved synthesis {done.mean() * 100:.1f}% "
                  f"({(~done).sum()} left)")

    st["iters"] = iters
    st["loop_s"] = time.perf_counter() - t_loop
    st["done"] = float(done.mean())
    st["total_s"] = time.perf_counter() - t_start
    return {
        "features": np.moveaxis(textures[None], -1, 1),  # [1, C, H, W]
        "mesh_vertices": mesh_proj.mesh.vertices,
        "mesh_faces": mesh_proj.mesh.faces,
        "uv": mesh_proj.arrays.uvs.cpu().numpy(),
        "phi_embed": None,
        "local_tbn": None,
        "sdf_factor": gap / original_grid_gap,
        "original_grid_gap": original_grid_gap,
    }


def _interp_on_grid(p_verts: np.ndarray, values: np.ndarray,
                    query: np.ndarray) -> np.ndarray:
    """Inverse-distance blend of the 3 nearest patch texels' values at
    the 3D query points."""
    flat_v = p_verts.reshape(-1, 3)
    flat_f = values.reshape(-1, values.shape[-1])
    tree = cKDTree(flat_v)
    d, idx = tree.query(query, k=min(3, len(flat_v)))
    if d.ndim == 1:
        return flat_f[idx]
    w = 1.0 / (d + 1e-9)
    w /= w.sum(-1, keepdims=True)
    return (flat_f[idx] * w[..., None]).sum(-2)
