"""Baked surface-texture rendering (port of
``nerf_texture_tpu/render/baked.py``).

The surface embedding x_embed and the phi embedding are functions of the
surface point alone, and the render's chart p_sur(x) is planar per
anchor cell, so the encode can be evaluated once per trained state into
small 2D texture tiles, one per chart.  A sample then reads ONE
corner-packed atlas row: the 2x2 bilinear corners x (16 feature + 8 phi)
channels = 96 bf16 lanes of a 128-lane row, in place of the 8-level hash
pyramid and the phi grid.

The charts come from the column-collapsed anchor table
(``geometry.projector.build_anchor_table(collapse_columns=True)``): all
cells of a normal column share one chart, so there is one tile per
SURFACE cell.  Cells without a tile render as empty space.

The JAX module jits the bake's chunk update and donates the atlas; here
the bake is a plain chunk loop under ``torch.no_grad`` writing the atlas
in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the tile count is padded to a multiple of this (or of the chunk): the
# atlas then has the JAX package's layout, row for row
TILE_BUCKET = 1024


@dataclasses.dataclass
class BakedAtlas:
    """A baked feature atlas: tensors on one device and its layout."""

    tile_of_cell: torch.Tensor  # [H^3] int32, -1 = no tile
    atlas: torch.Tensor         # [n_pad * T * T, 128] bf16, corner-packed
    anchors: torch.Tensor       # [n_pad, 12] f32: p0[3] t[3] b[3] n[3]
    T: int
    extent: float
    n_channels: int
    grid_size: int
    bound: float


def _orthonormal_frame(p0, normal, tangent):
    """(t_hat, b_hat) spanning the plane perpendicular to ``normal``
    (numpy arrays or tensors [..., 3]).  The vertex TBN's tangent is not
    exactly orthogonal to the kNN-weighted anchor normal; bake and lookup
    must agree on the same in-plane axes, so both use this.  A tangent
    parallel to the normal falls back to another perpendicular."""
    xp = np if isinstance(normal, np.ndarray) else torch

    def vnorm(a):
        return xp.linalg.norm(a, axis=-1, keepdims=True)

    n = normal / (vnorm(normal) + 1e-9)
    t = tangent - xp.sum(tangent * n, axis=-1, keepdims=True) * n
    tn = vnorm(t)
    alt = xp.stack([n[..., 1] - n[..., 2], n[..., 2] - n[..., 0],
                    n[..., 0] - n[..., 1]], -1)
    t = xp.where(tn > 1e-6, t / (tn + 1e-12), alt / (vnorm(alt) + 1e-12))
    b = np.cross(n, t) if xp is np else torch.linalg.cross(n, t)
    return t, b


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def plan_bake(anchor_tab, occ, grid_size: int, bound: float):
    """The bake plan, on the host, from the (collapsed) anchor table
    [H, H, H, 16] and the occupancy [cascades * H^3]: (tile_of_cell
    [H^3] int32, the tiles' anchor rows [n_tiles, 16], n_tiles).  A tile
    goes to every surface cell referenced by an occupied cell, or a
    neighbour of one (1-cell dilation: the proxy's trilinear reach), that
    passes the anchor hit gate."""
    H = grid_size
    tab = _host(anchor_tab).reshape(-1, 16)
    occ_np = _host(occ).reshape(-1)[:H ** 3]        # cascade 0
    g = (occ_np > 0).reshape(H, H, H)
    for ax in range(3):
        g = g | np.roll(g, 1, ax) | np.roll(g, -1, ax)
    sel = g.reshape(-1) & (tab[:, 15] > 0.5)
    # surface cell of each selected cell = the cell holding its p0
    cell = np.clip(((tab[:, 0:3] + bound) * (H / (2.0 * bound)))
                   .astype(np.int64), 0, H - 1)
    surf = (cell[:, 0] * H + cell[:, 1]) * H + cell[:, 2]
    uniq, inv = np.unique(surf[sel], return_inverse=True)
    tile_of_cell = np.full(H ** 3, -1, np.int32)
    tile_of_cell[np.where(sel)[0]] = inv.astype(np.int32)
    return tile_of_cell, tab[uniq], len(uniq)


@torch.no_grad()
def bake_atlas(encode_fn, anchor_tab, occ, grid_size: int, bound: float,
               *, T: int = 16, n_channels: int, chunk_tiles: int = 1024,
               max_bytes: float = 8e9) -> BakedAtlas:
    """Evaluate ``encode_fn`` ([P, 3] world points -> [P, n_channels]
    f32) on every texel of every tile and pack the atlas, ``chunk_tiles``
    tiles a chunk, on the anchor table's device.

    Tile t spans +-(extent / 2) around its chart origin p0 along the
    chart's (t_hat, b_hat), extent = 2 r T / (T - 1) with r half the cell
    diagonal.  The tile count is padded to a multiple of
    max(TILE_BUCKET, chunk_tiles) (the padding repeats the last tile),
    and the atlas would take n_pad T^2 x 256 bytes: more than
    ``max_bytes`` raises.  Row (k T + i) T + j holds the texels (i,
    j), (i, j+1), (i+1, j), (i+1, j+1), clamped at the tile edge, so a
    bilinear read is one row."""
    device = anchor_tab.device
    tile_of_cell, rows, n_tiles = plan_bake(anchor_tab, occ, grid_size,
                                            bound)
    if n_tiles == 0:
        raise ValueError("bake: no tiles (empty occupancy or no anchors)")
    C = n_channels
    if 4 * C > 128:
        raise ValueError(f"bake row would need {4 * C} lanes > 128")
    cell = 2.0 * bound / grid_size
    r = cell * np.sqrt(3.0) / 2.0
    extent = 2.0 * r * T / (T - 1)
    bucket = max(TILE_BUCKET, chunk_tiles)
    n_pad = -(-n_tiles // bucket) * bucket
    bytes_est = n_pad * T * T * 256
    if bytes_est > max_bytes:
        raise ValueError(f"bake atlas too large: {bytes_est / 1e9:.1f} GB "
                         f"({n_tiles} tiles x {T}x{T}); raise max_bytes "
                         "or lower T")
    p0 = rows[:, 0:3]
    t_hat, b_hat = _orthonormal_frame(p0, rows[:, 3:6], rows[:, 6:9])
    rows9 = np.concatenate([p0, t_hat, b_hat], axis=-1).astype(np.float32)
    rows9 = torch.as_tensor(np.pad(rows9, ((0, n_pad - n_tiles), (0, 0)),
                                   mode="edge"), device=device)
    frac = torch.as_tensor(
        ((np.arange(T, dtype=np.float32) + 0.5) / T - 0.5) * extent,
        device=device)
    atlas = torch.zeros((n_pad * T * T, 128), dtype=torch.bfloat16,
                        device=device)
    for start in range(0, n_pad, chunk_tiles):
        rc = rows9[start:start + chunk_tiles]
        n = rc.shape[0]
        pts = (rc[:, None, None, 0:3]
               + frac[None, :, None, None] * rc[:, None, None, 3:6]
               + frac[None, None, :, None] * rc[:, None, None, 6:9])
        vals = encode_fn(pts.reshape(-1, 3)).reshape(n, T, T, C)
        jp = torch.cat([vals[:, :, 1:], vals[:, :, -1:]], dim=2)
        ip = torch.cat([vals[:, 1:], vals[:, -1:]], dim=1)
        ijp = torch.cat([ip[:, :, 1:], ip[:, :, -1:]], dim=2)
        packed = torch.cat([vals, jp, ip, ijp], dim=-1).reshape(-1, 4 * C)
        atlas[start * T * T:(start + n) * T * T, :4 * C] = packed.to(
            torch.bfloat16)
    anchors = np.zeros((n_pad, 12), np.float32)
    anchors[:n_tiles] = np.concatenate([p0, t_hat, b_hat, rows[:, 3:6]],
                                       axis=-1)
    return BakedAtlas(
        tile_of_cell=torch.as_tensor(tile_of_cell, device=device),
        atlas=atlas, anchors=torch.as_tensor(anchors, device=device),
        T=T, extent=float(extent), n_channels=C, grid_size=grid_size,
        bound=bound)


def extend_anchor_table(anchor_tab: torch.Tensor, tile_of_cell: torch.Tensor,
                        anchors: torch.Tensor) -> torch.Tensor:
    """[H^3, 24] rows: the anchor row (0:16: p0, normal, tbn, hit), the
    cell's tile id as a float (16; -1 = none) and the tile's t_hat
    (17:20) and b_hat (20:23), and a pad lane: so the baked render pays
    one row gather a sample for the chart and the tile."""
    tab = anchor_tab.reshape(-1, 16)
    ar = anchors[torch.clamp(tile_of_cell, min=0).to(torch.int64)]
    return torch.cat([tab, tile_of_cell[:, None].to(torch.float32),
                      ar[:, 3:6], ar[:, 6:9], torch.zeros_like(tab[:, :1])],
                     dim=1)


def anchor_frames_ext(bake: BakedAtlas, table_ext: torch.Tensor,
                      x_seed: torch.Tensor, seed_valid: torch.Tensor):
    """Frames and tile addressing of points x_seed [N, 3] by one row
    gather from ``extend_anchor_table``'s table (the cell index truncates
    toward zero, as the JAX ``astype(int32)``)."""
    H, b = bake.grid_size, bake.bound
    cell = torch.clamp(((x_seed + b) * (H / (2.0 * b))).to(torch.int32),
                       0, H - 1).to(torch.int64)
    flat = (cell[..., 0] * H + cell[..., 1]) * H + cell[..., 2]
    rows = table_ext[flat]
    return {"p0": rows[:, 0:3], "normal": rows[:, 3:6],
            "tbn": rows[:, 6:15].reshape(-1, 3, 3),
            "hit": seed_valid & (rows[:, 15] > 0.5),
            "tile": rows[:, 16].to(torch.int32),
            "t_hat": rows[:, 17:20], "b_hat": rows[:, 20:23]}


def lookup(bake: BakedAtlas, frames, x: torch.Tensor):
    """Bilinear atlas read at the chart coordinates of x [N, 3].

    frames: the samples' anchor frames.  With the tile addressing of
    ``anchor_frames_ext`` ('tile', 't_hat', 'b_hat') nothing more is
    gathered; otherwise the tile id comes from the cell of x and the
    tile's own axes from ``bake.anchors``.  Returns (values [N, C] f32,
    zero where there is no tile; ok [N] bool)."""
    H, T, C = bake.grid_size, bake.T, bake.n_channels
    b = bake.bound
    if "tile" in frames:
        k = frames["tile"]
        ks = torch.clamp(k, min=0).to(torch.int64)
        p0, t_hat, b_hat = frames["p0"], frames["t_hat"], frames["b_hat"]
    else:
        cell = torch.clamp(((x + b) * (H / (2.0 * b))).to(torch.int32),
                           0, H - 1).to(torch.int64)
        flat = (cell[..., 0] * H + cell[..., 1]) * H + cell[..., 2]
        k = bake.tile_of_cell[flat]
        ks = torch.clamp(k, min=0).to(torch.int64)
        arow = bake.anchors[ks]
        p0, t_hat, b_hat = arow[:, 0:3], arow[:, 3:6], arow[:, 6:9]
    ok = k >= 0
    delta = x - p0
    # t_hat / b_hat are perpendicular to the chart normal: the height
    # component of delta drops out
    u = torch.sum(delta * t_hat, -1) / bake.extent + 0.5
    v = torch.sum(delta * b_hat, -1) / bake.extent + 0.5
    xt = torch.clamp(u * T - 0.5, 0.0, T - 1.0)
    yt = torch.clamp(v * T - 0.5, 0.0, T - 1.0)
    i0 = torch.clamp(xt.to(torch.int64), max=T - 2)
    j0 = torch.clamp(yt.to(torch.int64), max=T - 2)
    fu = (xt - i0)[:, None]
    fv = (yt - j0)[:, None]
    rows = bake.atlas[(ks * T + i0) * T + j0].to(torch.float32)
    c00, c01 = rows[:, 0:C], rows[:, C:2 * C]
    c10, c11 = rows[:, 2 * C:3 * C], rows[:, 3 * C:4 * C]
    val = ((1 - fu) * ((1 - fv) * c00 + fv * c01)
           + fu * ((1 - fv) * c10 + fv * c11))
    return torch.where(ok[:, None], val, 0.0), ok
