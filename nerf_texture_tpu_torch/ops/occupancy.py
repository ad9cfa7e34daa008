"""Occupancy / density grid state for empty-space skipping (port of
``nerf_texture_tpu/ops/occupancy.py``).

The grid is C-order ``[cascade, H, H, H]`` flattened, as in the JAX
package, so a converted grid maps cell for cell.  A refresh queries the
density at one jittered point per cell (all cells, or in partial mode a
quarter uniform and a quarter occupied), merges it into an EMA and
thresholds it.  Its random draws come from ``grid_draws`` (or from the
caller), so that a test can hand the port the JAX package's draws.

``update_host_sparse`` is the curved model's refresh: only the
near-surface cells are queried (the field is zero outside its thin
shell), chunk by chunk, with the jitter of ``sparse_draws``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class OccupancyGrid(NamedTuple):
    """Density-grid state; all fields are tensors on one device."""

    density: torch.Tensor       # [cascade, H**3] f32; -1 marks untrained
    occ: torch.Tensor           # [cascade * H**3] uint8 0/1 occupancy
    mean_density: torch.Tensor  # [] f32
    iter_density: torch.Tensor  # [] int32

    @property
    def cascades(self) -> int:
        return self.density.shape[0]


def create(grid_size: int = 128, cascades: int = 1,
           device: torch.device | str = "cuda") -> OccupancyGrid:
    return OccupancyGrid(
        density=torch.zeros((cascades, grid_size ** 3), dtype=torch.float32,
                            device=device),
        occ=torch.zeros((cascades * grid_size ** 3,), dtype=torch.uint8,
                        device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        iter_density=torch.zeros((), dtype=torch.int32, device=device),
    )


def grid_coords(grid_size: int, device: torch.device | str) -> torch.Tensor:
    """[H**3, 3] int64 integer cell coords in C-order (x-major)."""
    H = grid_size
    idx = torch.arange(H ** 3, device=device)
    return torch.stack([idx // (H * H), (idx // H) % H, idx % H], dim=-1)


class GridDraws(NamedTuple):
    """One cascade's random draws of a refresh."""

    noise: torch.Tensor                # [n, 3] jitter in [-half, half)
    cells: torch.Tensor | None = None  # partial: [H^3 / 4] uniform cells
    keys: torch.Tensor | None = None   # partial: [H^3] U(0, 1) sort keys


def grid_draws(generator: torch.Generator, *, grid_size: int,
               cascades: int, bound: float, full: bool) -> list[GridDraws]:
    """The draws of one refresh, per cascade, on the generator's device
    (the same distributions the JAX ``update`` draws from its key)."""
    H = grid_size
    dev = generator.device
    out = []
    for cas in range(cascades):
        half = min(2 ** cas, bound) / H
        if full:
            u = torch.rand((H ** 3, 3), generator=generator, device=dev)
            out.append(GridDraws(noise=u * (2.0 * half) - half))
            continue
        n = H ** 3 // 4
        cells = torch.randint(0, H ** 3, (n,), generator=generator,
                              device=dev)
        keys = torch.rand((H ** 3,), generator=generator, device=dev)
        u = torch.rand((2 * n, 3), generator=generator, device=dev)
        out.append(GridDraws(noise=u * (2.0 * half) - half, cells=cells,
                             keys=keys))
    return out


def _cell_points(coords, cas: int, grid_size: int, bound: float):
    """Cell-centre points of integer coords [n, 3] in cascade ``cas``."""
    H = grid_size
    cas_bound = min(2 ** cas, bound)
    half = cas_bound / H
    xyz = 2.0 * (coords.to(torch.float32) + 0.5) / H - 1.0
    return xyz * (cas_bound - half) / (1.0 - 1.0 / H)


def cell_points(cell_ids: torch.Tensor, noise: torch.Tensor, *,
                grid_size: int, cas: int, bound: float) -> torch.Tensor:
    """Jittered cell-centre points [n, 3] of flat cell ids [n] of cascade
    ``cas``; noise [n, 3] is the jitter in [-half, half) (the JAX
    function draws it from its key)."""
    H = grid_size
    coords = torch.stack([cell_ids // (H * H), (cell_ids // H) % H,
                          cell_ids % H], dim=-1)
    return _cell_points(coords, cas, H, bound) + noise


def sparse_draws(generator: torch.Generator, n_cells: int, *,
                 grid_size: int, cascades: int,
                 bound: float) -> list[torch.Tensor]:
    """The jitter of one ``update_host_sparse``: per cascade, [n_cells, 3]
    uniform in [-half, half), on the generator's device."""
    out = []
    for cas in range(cascades):
        half = min(2 ** cas, bound) / grid_size
        u = torch.rand((n_cells, 3), generator=generator,
                       device=generator.device)
        out.append(u * (2.0 * half) - half)
    return out


@torch.no_grad()
def update_host_sparse(state: OccupancyGrid, chunk_sigma_fn, draws,
                       cell_ids: torch.Tensor, *, grid_size: int,
                       cascades: int, density_thresh: float = 0.01,
                       decay: float = 0.95,
                       chunk: int = 65536) -> OccupancyGrid:
    """Full refresh restricted to the near-surface cells ``cell_ids`` [n]
    (int64, on the grid's device); every other cell's new density is 0
    (outside the shell), so the EMA still sees a full update.

    chunk_sigma_fn(ids [c], noise [c, 3], cas) -> [c] scaled sigmas, over
    slices of ``chunk`` cells; draws: per cascade, [n, 3] jitter
    (``sparse_draws``)."""
    H = grid_size
    tmp = torch.zeros((cascades, H ** 3), dtype=torch.float32,
                      device=state.density.device)
    n = cell_ids.shape[0]
    for cas in range(cascades):
        for start in range(0, n, chunk):
            ids = cell_ids[start:start + chunk]
            tmp[cas, ids] = chunk_sigma_fn(
                ids, draws[cas][start:start + chunk], cas).reshape(-1)
    return _finalize_update(state, tmp, decay, density_thresh)


def _chunked_density(density_fn, pts, chunk: int):
    """density_fn over pts [n, 3] in slices of ``chunk`` points -> [n]."""
    if not chunk or pts.shape[0] <= chunk:
        return density_fn(pts).reshape(-1)
    return torch.cat([density_fn(pts[i:i + chunk]).reshape(-1)
                      for i in range(0, pts.shape[0], chunk)])


@torch.no_grad()
def update(state: OccupancyGrid, density_fn, draws: list[GridDraws], *,
           grid_size: int, cascades: int, bound: float,
           density_thresh: float = 0.01, density_scale: float = 1.0,
           decay: float = 0.95, full: bool = True,
           chunk: int = 131072) -> OccupancyGrid:
    """EMA-refresh the density grid and recompute the occupancy mask.

    density_fn: [n, 3] points -> [n] raw sigma (before density_scale);
    draws: per cascade, from ``grid_draws(..., full=full)``.  Each queried
    cell takes max(old * decay, new) where both are valid; the mask is
    density > min(mean density, density_thresh)."""
    H = grid_size
    coords_all = grid_coords(H, state.density.device)
    tmp = -torch.ones_like(state.density)
    for cas in range(cascades):
        if full:
            pts = _cell_points(coords_all, cas, H, bound) + draws[cas].noise
            tmp[cas] = _chunked_density(density_fn, pts,
                                        chunk) * density_scale
            continue
        n = H ** 3 // 4
        # occupied cells without replacement: occupied cells sort first,
        # each under a random key
        keys = draws[cas].keys
        idx_o = torch.argsort(torch.where(state.density[cas] > 0, keys,
                                          2.0 + keys))[:n]
        idx = torch.cat([draws[cas].cells, idx_o])
        pts = (_cell_points(coords_all[idx], cas, H, bound)
               + draws[cas].noise)
        tmp[cas, idx] = _chunked_density(density_fn, pts,
                                         chunk) * density_scale
    return _finalize_update(state, tmp, decay, density_thresh)


def _finalize_update(state: OccupancyGrid, tmp, decay: float,
                     density_thresh: float) -> OccupancyGrid:
    """EMA merge: cells both trained (density >= 0) and re-sampled (tmp >=
    0) take max(density * decay, tmp), every other cell keeps its value;
    untrained cells stay at -1."""
    valid = (state.density >= 0) & (tmp >= 0)
    density = torch.where(valid, torch.maximum(state.density * decay, tmp),
                          state.density)
    mean_density = torch.mean(torch.clamp(density, min=0.0))
    thresh = torch.clamp(mean_density, max=density_thresh)
    occ = (density.reshape(-1) > thresh).to(torch.uint8)
    return OccupancyGrid(density=density, occ=occ, mean_density=mean_density,
                         iter_density=state.iter_density + 1)


@torch.no_grad()
def mark_untrained(state: OccupancyGrid, poses, intrinsics, *,
                   grid_size: int, cascades: int,
                   bound: float) -> OccupancyGrid:
    """Mark the cells that no training camera sees as density -1: a cell
    survives if it lies in front of some camera and inside its frustum
    (with a half-cell margin).  poses [B, 4, 4] cam2world, intrinsics
    [4] (fx, fy, cx, cy)."""
    H = grid_size
    fx, fy, cx, cy = (intrinsics[0], intrinsics[1], intrinsics[2],
                      intrinsics[3])
    coords = grid_coords(H, state.density.device).to(torch.float32)
    world = 2.0 * coords / (H - 1) - 1.0
    density = state.density.clone()
    rot = poses[:, :3, :3]
    trans = poses[:, :3, 3]
    for cas in range(cascades):
        cas_bound = min(2 ** cas, bound)
        half = cas_bound / H
        pts = world * (cas_bound - half)
        # world -> camera: (p - t) @ R
        cam = (torch.einsum("nc,bcd->bnd", pts, rot)
               - torch.einsum("bc,bcd->bd", trans, rot)[:, None, :])
        in_z = cam[..., 2] > 0
        in_x = torch.abs(cam[..., 0]) < cx / fx * cam[..., 2] + half * 2
        in_y = torch.abs(cam[..., 1]) < cy / fy * cam[..., 2] + half * 2
        seen = torch.any(in_z & in_x & in_y, dim=0)
        density[cas] = torch.where(seen, density[cas], -1.0)
    return state._replace(density=density)
