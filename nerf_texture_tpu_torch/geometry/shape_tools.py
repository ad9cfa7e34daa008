"""Mesh-processing tools (port of
``nerf_texture_tpu/geometry/shape_tools.py``): the optional convex
decomposition and manifold union (external binaries, passed through when
absent), largest-component cleanup, laplacian smoothing, 1 -> 4
subdivision, isotropic remeshing, bbox alignment, ICP, the chamfer
distance, PCA plane fitting, normalisation, ARAP deformation, and the
template registration.

Everything but ``register_template`` is host numpy, mirrored statement
for statement so that its output equals the JAX package's bit for bit
(``subdivide`` keeps the dict-ordered midpoint vertex ids: ``unhash``
indexes its features by them).  ``register_template`` is an Adam loop on
the vertex offsets on ``device``; its surface samples are drawn from a
``torch.Generator``, or by a ``draws`` callable (a test hands it the
JAX package's draws).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Callable

import numpy as np
import torch

from .mesh import Mesh


# ---------------------------------------------------------------------------
# external-binary wrappers (optional; pass the input through when absent)
# ---------------------------------------------------------------------------

def coacd(mesh_path: str, threshold: float = 0.05,
          binary: str = "coacd") -> str:
    """Convex decomposition by the CoACD binary.  Returns the decomposed
    path, or the input path when the binary is not on PATH."""
    out_path = mesh_path.rsplit(".", 1)[0] + "_coacd.obj"
    if shutil.which(binary) is None:
        print(f"[shape_tools] {binary} not found; skipping decomposition")
        return mesh_path
    subprocess.run([binary, "-i", mesh_path, "-o", out_path, "-t",
                    str(threshold)], check=False)
    return out_path if os.path.exists(out_path) else mesh_path


def manifold_union(mesh_path: str, sv_dir: str,
                   binary: str = "manifold") -> str:
    """Watertight manifold union by the Manifold binary into ``sv_dir``;
    the input path when the binary is not on PATH."""
    name = os.path.basename(mesh_path).rsplit(".", 1)[0]
    out_path = os.path.join(sv_dir, name + "_mf.obj")
    if shutil.which(binary) is None:
        print(f"[shape_tools] {binary} not found; skipping manifold union")
        return mesh_path
    subprocess.run([binary, mesh_path, out_path], check=False)
    return out_path if os.path.exists(out_path) else mesh_path


# ---------------------------------------------------------------------------
# host numpy
# ---------------------------------------------------------------------------

def _vertex_adjacency(mesh: Mesh):
    nbr: list[set] = [set() for _ in range(len(mesh.vertices))]
    for a, b in mesh.edges_unique:
        nbr[a].add(b)
        nbr[b].add(a)
    return nbr


def keep_largest_component(mesh: Mesh) -> Mesh:
    """Drop every face component but the largest (by face count): the
    floating blobs of an isosurface of a briefly trained density."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    f = mesh.faces
    n = len(mesh.vertices)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    adj = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                        shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    counts = np.bincount(labels[f[:, 0]])
    keep_label = int(np.argmax(counts))
    fkeep = f[labels[f[:, 0]] == keep_label]
    used = np.unique(fkeep)
    remap = np.zeros(n, np.int64)
    remap[used] = np.arange(len(used))
    return Mesh(mesh.vertices[used].copy(), remap[fkeep],
                None if mesh.uvs is None else mesh.uvs[used].copy())


def laplacian_smooth(mesh: Mesh, iterations: int = 8,
                     lamb: float = 0.5) -> Mesh:
    """Uniform laplacian smoothing: each step moves every vertex by
    ``lamb`` towards the mean of its neighbours."""
    nbr = _vertex_adjacency(mesh)
    max_deg = max((len(s) for s in nbr), default=1)
    idx = np.zeros((len(nbr), max_deg), np.int64)
    deg = np.zeros(len(nbr), np.int64)
    for i, s in enumerate(nbr):
        lst = sorted(s)
        idx[i, :len(lst)] = lst
        idx[i, len(lst):] = i
        deg[i] = max(len(lst), 1)
    v = mesh.vertices.copy()
    for _ in range(iterations):
        # padded slots point at the vertex itself; subtract them out
        mean = (v[idx].sum(1) - v * (max_deg - deg)[:, None]) \
            / deg[:, None]
        v = v + lamb * (mean - v)
    return Mesh(v, mesh.faces.copy(),
                None if mesh.uvs is None else mesh.uvs.copy())


def subdivide(mesh: Mesh) -> Mesh:
    """1 -> 4 subdivision with midpoint vertices, numbered in the order
    the faces first reach each edge."""
    verts = list(mesh.vertices)
    mid: dict[tuple, int] = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in mid:
            mid[key] = len(verts)
            verts.append((mesh.vertices[a] + mesh.vertices[b]) / 2)
        return mid[key]

    faces = []
    for f in mesh.faces:
        a, b, c = int(f[0]), int(f[1]), int(f[2])
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return Mesh(np.asarray(verts), np.asarray(faces, np.int64))


def subdivide_to(mesh: Mesh, min_vertices: int) -> Mesh:
    """Subdivide until the mesh has at least ``min_vertices``."""
    out = mesh
    while len(out.vertices) < min_vertices:
        out = subdivide(out)
    return out


def remesh_isotropic(mesh: Mesh, target_edge: float | None = None,
                     iterations: int = 3) -> Mesh:
    """Subdivide long edges and relax tangentially (laplacian), without
    collapses, so the topology is kept."""
    out = mesh
    if target_edge is None:
        target_edge = out.mean_edge_length
    for _ in range(iterations):
        if out.mean_edge_length > 1.4 * target_edge:
            out = subdivide(out)
        out = laplacian_smooth(out, iterations=2, lamb=0.3)
    return out


def align_bbox(src: Mesh, trg: Mesh) -> Mesh:
    """Scale and translate ``src`` so that its bbox matches ``trg``'s."""
    sc = (src.vertices.max(0) + src.vertices.min(0)) / 2
    ss = np.abs(src.vertices - sc).max()
    tc = (trg.vertices.max(0) + trg.vertices.min(0)) / 2
    ts = np.abs(trg.vertices - tc).max()
    v = (src.vertices - sc) / ss * ts + tc
    return Mesh(v, src.faces.copy())


def icp(src_pts: np.ndarray, trg_pts: np.ndarray, iterations: int = 30,
        threshold: float = 0.02):
    """Point-to-point ICP.  Returns (T [4, 4], the transformed src)."""
    from scipy.spatial import cKDTree

    src = src_pts.copy()
    T_total = np.eye(4)
    tree = cKDTree(trg_pts)
    for _ in range(iterations):
        d, idx = tree.query(src)
        keep = d < max(threshold, np.median(d) * 2)
        if keep.sum() < 3:
            break
        a = src[keep]
        b = trg_pts[idx[keep]]
        ca, cb = a.mean(0), b.mean(0)
        H = (a - ca).T @ (b - cb)
        U, _, Vt = np.linalg.svd(H)
        R = Vt.T @ U.T
        if np.linalg.det(R) < 0:
            Vt[-1] *= -1
            R = Vt.T @ U.T
        t = cb - R @ ca
        src = src @ R.T + t
        T_step = np.eye(4)
        T_step[:3, :3] = R
        T_step[:3, 3] = t
        T_total = T_step @ T_total
    return T_total, src


def chamfer_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric chamfer distance (mean squared nearest distances)."""
    from scipy.spatial import cKDTree

    d_ab, _ = cKDTree(b).query(a)
    d_ba, _ = cKDTree(a).query(b)
    return float((d_ab ** 2).mean() + (d_ba ** 2).mean())


def pca_plane(points: np.ndarray):
    """Fit a plane: (normal, center, transform into the plane [4, 4])."""
    center = points.mean(0)
    _, _, vt = np.linalg.svd(points - center, full_matrices=False)
    normal = vt[2]
    T = np.eye(4)
    T[:3, :3] = vt
    T[:3, 3] = -vt @ center
    return normal, center, T


def normalize_mesh(mesh: Mesh, scale: float = 1.5) -> Mesh:
    """Centre on the vertex mean and scale so that the largest |coord| is
    1 / ``scale``."""
    v = mesh.vertices - mesh.vertices.mean(0)
    v = v / (scale * np.abs(v).max() + 1e-12)
    return Mesh(v, mesh.faces.copy(),
                None if mesh.uvs is None else mesh.uvs.copy())


def arap_deform(mesh: Mesh, handle_ids: np.ndarray,
                handle_positions: np.ndarray, *,
                iterations: int = 10) -> Mesh:
    """As-rigid-as-possible deformation (Sorkine & Alexa 2007), uniform
    weights: per-vertex rotations from the SVD of the edge covariance,
    then one sparse Laplacian solve with the handles as hard constraints
    (factorised once)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import factorized

    V = np.asarray(mesh.vertices, np.float64)
    F = np.asarray(mesh.faces, np.int64)
    n = len(V)
    handle_ids = np.asarray(handle_ids, np.int64)
    handle_positions = np.asarray(handle_positions, np.float64)

    e = np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    ei = np.concatenate([e[:, 0], e[:, 1]])          # directed edges
    ej = np.concatenate([e[:, 1], e[:, 0]])
    A = sp.coo_matrix((np.ones(len(ei)), (ei, ej)), shape=(n, n)).tocsr()
    deg = np.asarray(A.sum(1)).ravel()
    L = (sp.diags(deg) - A).tocsr()
    free = np.setdiff1d(np.arange(n), handle_ids)
    solve = factorized(L[free][:, free].tocsc())
    L_fh = L[free][:, handle_ids]

    E0 = V[ei] - V[ej]                               # rest edges [E, 3]
    P = V.copy()
    P[handle_ids] = handle_positions
    for _ in range(iterations):
        # local step: R_i from the SVD of S_i = sum_j e0_ij e1_ij^T
        E1 = P[ei] - P[ej]
        S = np.zeros((n, 3, 3))
        np.add.at(S, ei, E0[:, :, None] * E1[:, None, :])
        U, _, Vt = np.linalg.svd(S)
        R = np.transpose(Vt, (0, 2, 1)) @ np.transpose(U, (0, 2, 1))
        det = np.linalg.det(R)
        Vt_fix = Vt.copy()
        Vt_fix[:, 2, :] *= np.sign(det)[:, None]
        R = np.transpose(Vt_fix, (0, 2, 1)) @ np.transpose(U, (0, 2, 1))
        # global step: L p' = b, b_i = sum_j 0.5 (R_i + R_j) (v_i - v_j)
        Rm = 0.5 * (R[ei] + R[ej])
        contrib = np.einsum("eab,eb->ea", Rm, E0)
        b = np.zeros((n, 3))
        np.add.at(b, ei, contrib)
        rhs = b[free] - L_fh @ P[handle_ids]
        P[free] = np.column_stack([solve(rhs[:, c]) for c in range(3)])
    return Mesh(P, F.copy(),
                None if mesh.uvs is None else mesh.uvs.copy())


# ---------------------------------------------------------------------------
# template registration (on the device)
# ---------------------------------------------------------------------------

Draws = Callable[[int, torch.Tensor], tuple]


def register_template(src: Mesh, trg_points: np.ndarray, *,
                      iterations: int = 300, lr: float = 0.05,
                      w_chamfer: float = 1.0, w_edge: float = 1.0,
                      w_laplacian: float = 0.5, n_samples: int = 2000,
                      seed: int = 0, draws: Draws | None = None,
                      device: torch.device | str = "cuda") -> Mesh:
    """Deform ``src`` towards the points ``trg_points`` by Adam on the
    vertex offsets: chamfer distance between ``n_samples`` surface
    samples and (up to ``n_samples`` of) the target points, plus the
    squared change of the edge lengths and the laplacian term.

    The target subset is drawn from ``np.random.default_rng(seed)`` as in
    the JAX function.  Every iteration samples the surface: ``draws(i,
    areas)`` -> (face ids [n] int64, u [n, 1], v [n, 1]) on ``device``
    given the faces' current areas; by default the faces by area
    (``torch.multinomial``) and u, v uniform from a ``torch.Generator``
    seeded with ``seed``."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    v0 = torch.as_tensor(np.asarray(src.vertices, np.float32), device=dev)
    faces = torch.as_tensor(src.faces, dtype=torch.int64, device=dev)
    edges = torch.as_tensor(src.edges_unique, dtype=torch.int64, device=dev)
    n_t = min(n_samples, len(trg_points))
    trg = torch.as_tensor(np.asarray(
        trg_points[rng.choice(len(trg_points), n_t, replace=False)],
        np.float32), device=dev)
    if draws is None:
        gen = torch.Generator(dev).manual_seed(seed)

        def draws(i, areas):
            fid = torch.multinomial(areas + 1e-12, n_samples,
                                    replacement=True, generator=gen)
            u = torch.rand((n_samples, 1), generator=gen, device=dev)
            v = torch.rand((n_samples, 1), generator=gen, device=dev)
            return fid, u, v

    nbr = _vertex_adjacency(src)
    max_deg = max(len(s) for s in nbr)
    nidx = np.zeros((len(nbr), max_deg), np.int64)
    nmask = np.zeros((len(nbr), max_deg), np.float32)
    for i, s in enumerate(nbr):
        lst = sorted(s)
        nidx[i, :len(lst)] = lst
        nmask[i, :len(lst)] = 1.0
    nidx = torch.as_tensor(nidx, device=dev)
    nmask = torch.as_tensor(nmask, device=dev)
    e0 = torch.linalg.norm(v0[edges[:, 0]] - v0[edges[:, 1]], dim=-1)

    offset = torch.zeros_like(v0, requires_grad=True)
    opt = torch.optim.Adam([offset], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for i in range(iterations):
        v = v0 + offset
        tris = v[faces]
        cr = torch.linalg.cross(tris[:, 1] - tris[:, 0],
                                tris[:, 2] - tris[:, 0], dim=-1)
        fid, su, sv = draws(i, 0.5 * torch.linalg.norm(cr.detach(), dim=-1))
        flip = (su + sv) > 1
        su = torch.where(flip, 1 - su, su)
        sv = torch.where(flip, 1 - sv, sv)
        t = tris[fid]
        pts = t[:, 0] * (1 - su - sv) + t[:, 1] * su + t[:, 2] * sv
        d = torch.sum((pts[:, None] - trg[None]) ** 2, -1)
        l_ch = torch.mean(torch.amin(d, 1)) + torch.mean(torch.amin(d, 0))
        el = torch.linalg.norm(v[edges[:, 0]] - v[edges[:, 1]], dim=-1)
        l_edge = torch.mean((el - e0) ** 2)
        mean_n = torch.sum(v[nidx] * nmask[..., None], 1) \
            / torch.clamp(torch.sum(nmask, 1, keepdim=True), min=1.0)
        l_lap = torch.mean(torch.sum((v - mean_n) ** 2, -1))
        loss = w_chamfer * l_ch + w_edge * l_edge + w_laplacian * l_lap
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return Mesh((v0 + offset).detach().cpu().numpy(), src.faces.copy())
