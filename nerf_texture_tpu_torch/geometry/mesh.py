"""Host-side triangle-mesh utilities (port of
``nerf_texture_tpu/geometry/mesh.py``): face and vertex normals, edge
statistics, the icosphere, box and plane primitives, OBJ and PLY files,
per-face TBN frames and the chart-based UV atlas.

All of it is numpy that runs on the host, mirrored statement for
statement so that a mesh built (or a file written) here equals the JAX
package's bit for bit.
"""

from __future__ import annotations

import numpy as np


class Mesh:
    """A minimal indexed triangle mesh (f64 vertices, int64 faces)."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 uvs: np.ndarray | None = None):
        self.vertices = np.asarray(vertices, np.float64)
        self.faces = np.asarray(faces, np.int64)
        self.uvs = None if uvs is None else np.asarray(uvs, np.float64)
        self._face_normals = None
        self._vertex_normals = None

    @property
    def face_normals(self) -> np.ndarray:
        if self._face_normals is None:
            tris = self.vertices[self.faces]
            n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
            norm = np.linalg.norm(n, axis=-1, keepdims=True)
            self._face_normals = n / np.maximum(norm, 1e-20)
        return self._face_normals

    @property
    def face_areas(self) -> np.ndarray:
        tris = self.vertices[self.faces]
        n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        return 0.5 * np.linalg.norm(n, axis=-1)

    @property
    def vertex_normals(self) -> np.ndarray:
        """Area-weighted vertex normals."""
        if self._vertex_normals is None:
            tris = self.vertices[self.faces]
            fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
            vn = np.zeros_like(self.vertices)
            for k in range(3):
                np.add.at(vn, self.faces[:, k], fn)
            norm = np.linalg.norm(vn, axis=-1, keepdims=True)
            self._vertex_normals = vn / np.maximum(norm, 1e-20)
        return self._vertex_normals

    @property
    def edges_unique(self) -> np.ndarray:
        e = np.concatenate([self.faces[:, [0, 1]], self.faces[:, [1, 2]],
                            self.faces[:, [2, 0]]], axis=0)
        return np.unique(np.sort(e, axis=-1), axis=0)

    @property
    def mean_edge_length(self) -> float:
        e = self.vertices[self.edges_unique]
        return float(np.linalg.norm(e[:, 0] - e[:, 1], axis=-1).mean())

    @property
    def aabb(self):
        return self.vertices.min(0), self.vertices.max(0)

    def copy(self) -> "Mesh":
        return Mesh(self.vertices.copy(), self.faces.copy(),
                    None if self.uvs is None else self.uvs.copy())


def make_icosphere(subdivisions: int = 2, radius: float = 1.0) -> Mesh:
    """Icosahedron subdivided ``subdivisions`` times (midpoints pushed to
    the unit sphere), scaled by ``radius``: 10 * 4**s + 2 vertices."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        np.int64)
    for _ in range(subdivisions):
        edge_mid: dict[tuple, int] = {}
        new_faces = []
        verts = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts)
                verts.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(verts)
        faces = np.asarray(new_faces, np.int64)
    return Mesh(verts * radius, faces)


def make_box(half_extent=(1.0, 1.0, 1.0)) -> Mesh:
    """Axis-aligned box of 12 triangles."""
    h = np.asarray(half_extent, np.float64)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float64) * h
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    return Mesh(corners, np.asarray(faces, np.int64))


def make_plane(n: int = 8, size: float = 1.0) -> Mesh:
    """Regular triangulated n x n grid on z = 0 with natural uvs."""
    xs = np.linspace(-size, size, n)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([xx.ravel(), yy.ravel(), np.zeros(n * n)], -1)
    uvs = np.stack([(xx.ravel() + size) / (2 * size),
                    (yy.ravel() + size) / (2 * size)], -1)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces += [[a, a + n, a + 1], [a + 1, a + n, a + n + 1]]
    return Mesh(verts, np.asarray(faces, np.int64), uvs)


def load_obj(path: str) -> Mesh:
    """Vertices, faces (polygons split into fans) and, where every face
    has them, per-vertex uvs of an OBJ file."""
    verts, uvs, faces, face_uvs = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                items = line.split()[1:]
                vi, ti = [], []
                for it in items:
                    parts = it.split("/")
                    vi.append(int(parts[0]) - 1)
                    if len(parts) > 1 and parts[1]:
                        ti.append(int(parts[1]) - 1)
                for k in range(1, len(vi) - 1):
                    faces.append([vi[0], vi[k], vi[k + 1]])
                    if ti:
                        face_uvs.append([ti[0], ti[k], ti[k + 1]])
    vertices = np.asarray(verts, np.float64)
    faces_arr = np.asarray(faces, np.int64)
    vert_uvs = None
    if uvs and face_uvs and len(face_uvs) == len(faces):
        uvs_arr = np.asarray(uvs, np.float64)
        vert_uvs = np.zeros((len(vertices), 2))
        vert_uvs[faces_arr.ravel()] = uvs_arr[
            np.asarray(face_uvs, np.int64).ravel()]
    return Mesh(vertices, faces_arr, vert_uvs)


def save_obj(path: str, mesh: Mesh):
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if mesh.uvs is not None:
            for t in mesh.uvs:
                f.write(f"vt {t[0]} {t[1]}\n")
            for face in mesh.faces + 1:
                f.write(f"f {face[0]}/{face[0]} {face[1]}/{face[1]} "
                        f"{face[2]}/{face[2]}\n")
        else:
            for face in mesh.faces + 1:
                f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def save_ply_points(path: str, points: np.ndarray,
                    colors: np.ndarray | None = None):
    """ASCII PLY point cloud (with optional uchar colours)."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            line = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
            if colors is not None:
                c = colors[i].astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")


def load_ply_points(path: str) -> np.ndarray:
    pts = []
    with open(path) as f:
        n = 0
        for line in f:
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.strip() == "end_header":
                break
        for _ in range(n):
            pts.append([float(x) for x in f.readline().split()[:3]])
    return np.asarray(pts, np.float64)


def calculate_tbn(mesh: Mesh, uvs: np.ndarray,
                  force_orthogonal: bool = True) -> np.ndarray:
    """Per-face tangent/bitangent/normal frames from UVs: solve the 2x2
    uv-edge system for (T, B), append the face normal, optionally
    re-orthogonalise B = N x T, and row-normalise.  [F, 3, 3], rows
    (T, B, N)."""
    vertices, faces = mesh.vertices, mesh.faces
    normals = mesh.face_normals
    fv = vertices[faces]                       # F, 3, 3
    fuv = uvs[faces]                           # F, 3, 2
    ev = fv[:, 1:] - fv[:, :1]                 # F, 2, 3
    euv = fuv[:, 1:] - fuv[:, :1]              # F, 2, 2
    det = np.linalg.det(euv)
    bad = np.abs(det) < 1e-10
    if bad.any():
        euv = euv.copy()
        euv[bad, 1, 1] += 1e-3
    tb = np.einsum("mab,mbc->mac", np.linalg.inv(euv), ev)   # F, 2, 3
    tbn = np.concatenate([tb, normals[:, None]], axis=1)     # F, 3, 3
    if force_orthogonal:
        tbn[:, 1] = np.cross(tbn[:, 2], tbn[:, 0], axis=-1)
    return tbn / np.maximum(
        np.linalg.norm(tbn, axis=-1, keepdims=True), 1e-20)


def uv_atlas(mesh: Mesh, normal_threshold: float = 0.7) -> Mesh:
    """Chart-based UV parameterisation: greedy region-grow faces into
    charts of similar normal, project each chart onto its plane, and
    shelf-pack the charts into [0, 1]^2.  Vertices on chart boundaries
    are duplicated (per-chart re-indexing).  Returns a NEW mesh with
    per-vertex uvs in [0, 1]."""
    F = len(mesh.faces)
    fn = mesh.face_normals

    # face adjacency via shared edges
    edge_map: dict[tuple, list[int]] = {}
    for fi, face in enumerate(mesh.faces):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = (min(face[a], face[b]), max(face[a], face[b]))
            edge_map.setdefault(key, []).append(fi)
    adj: list[list[int]] = [[] for _ in range(F)]
    for fs in edge_map.values():
        for i in fs:
            for j in fs:
                if i != j:
                    adj[i].append(j)

    chart_of = -np.ones(F, np.int64)
    charts: list[list[int]] = []
    order = np.argsort(-mesh.face_areas)       # big faces seed first
    for seed in order:
        if chart_of[seed] >= 0:
            continue
        cid = len(charts)
        ref_n = fn[seed].copy()
        stack = [int(seed)]
        members: list[int] = []
        chart_of[seed] = cid
        while stack:
            f = stack.pop()
            members.append(f)
            for nb in adj[f]:
                if chart_of[nb] < 0 and np.dot(fn[nb],
                                               ref_n) > normal_threshold:
                    chart_of[nb] = cid
                    stack.append(nb)
        charts.append(members)

    # per-chart planar projection + per-chart vertex duplication
    new_verts, new_uvs, new_faces = [], [], []
    chart_rects = []
    for members in charts:
        members = np.asarray(members)
        n = fn[members].mean(0)
        n /= np.linalg.norm(n) + 1e-20
        up = np.array([0.0, 0.0, 1.0]) if abs(n[2]) < 0.9 else np.array(
            [1.0, 0.0, 0.0])
        t = np.cross(up, n)
        t /= np.linalg.norm(t) + 1e-20
        b = np.cross(n, t)
        vids = np.unique(mesh.faces[members].ravel())
        local = {int(v): i for i, v in enumerate(vids)}
        pts = mesh.vertices[vids]
        uv = np.stack([pts @ t, pts @ b], axis=-1)
        uv -= uv.min(0)
        base = len(new_verts)
        new_verts.extend(pts.tolist())
        new_uvs.extend(uv.tolist())
        for f in members:
            new_faces.append([base + local[int(v)]
                              for v in mesh.faces[f]])
        chart_rects.append((base, len(vids), uv.max(0) + 1e-9))

    # shelf packing, tallest chart first
    pad_frac = 0.01
    total_area = sum(r[2][0] * r[2][1] for r in chart_rects)
    scale = 1.0 / np.sqrt(total_area * 2.0 + 1e-20)
    uvs = np.asarray(new_uvs) * scale
    rects = [(i, r[0], r[1], r[2] * scale) for i, r in
             enumerate(chart_rects)]
    rects.sort(key=lambda r: -r[3][1])
    x = y = shelf_h = 0.0
    offsets = np.zeros((len(chart_rects), 2))
    for i, _, _, wh in rects:
        w, h = wh + pad_frac
        if x + w > 1.0 and x > 0:
            x = 0.0
            y += shelf_h
            shelf_h = 0.0
        offsets[i] = (x, y)
        x += w
        shelf_h = max(shelf_h, h)
    height = y + shelf_h
    for i, (base, nv, _) in enumerate(chart_rects):
        uvs[base:base + nv] += offsets[i]
    uvs /= max(1.0, height)                    # fit into [0, 1]
    uvs = np.clip(uvs, 0.0, 1.0)
    return Mesh(np.asarray(new_verts), np.asarray(new_faces, np.int64),
                uvs)
