"""Flat (2D) implicit-texture synthesis by patch matching and quilting
(host numpy mirror of ``nerf_texture_tpu/synthesis/quilting.py``, kept
statement for statement so that both packages quilt the same canvas from
the same patches).

Raster-scan a canvas of raw latent channels (features || phi_embed ||
local_tbn), match candidate patches by their top/left overlap strips with
(block-reduced) KD-trees, pick probabilistically by distance
attenuation, reject patches sampled too close on the source surface, and
stitch with a minimum-error-boundary DP cut.  The output is the
``texture.npz`` payload: features [H, W, C], grid_gap, sample_tbn,
sample_tbn_ids, phi_embed, local_tbn.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.spatial import cKDTree


def block_reduce_mean(x: np.ndarray, block: tuple) -> np.ndarray:
    """Mean-pooling block reduce (skimage.measure.block_reduce stand-in).
    Truncates ragged edges."""
    slices = []
    shape = []
    for dim, b in zip(x.shape, block):
        n = dim // b
        slices.append(slice(0, n * b))
        shape.extend([n, b])
    x = x[tuple(slices)].reshape(shape)
    axes = tuple(range(1, x.ndim, 2))
    return x.mean(axis=axes)


def min_error_boundary_cut(b1: np.ndarray, b2: np.ndarray,
                           match_dim: int):
    """Seam two overlapping strips [H, W, C] along a minimal-error path.

    Vectorized DP over rows (the reference's per-cell loop,
    patch_matching_and_quilting.py:385-424): each row's seam column moves
    at most one step.  Returns (stitched, mask_left_of_seam)."""
    H, W = b1.shape[:2]
    e = ((b1[..., :match_dim] - b2[..., :match_dim]) ** 2).sum(-1)
    E = np.zeros_like(e)
    T = np.zeros((H, W), np.int64)
    E[0] = e[0]
    T[0] = np.arange(W)
    for i in range(1, H):
        prev = np.concatenate([[np.inf], E[i - 1], [np.inf]])
        cand = np.stack([prev[0:W], prev[1:W + 1], prev[2:W + 2]])
        choice = np.argmin(cand, axis=0)          # 0: j-1, 1: j, 2: j+1
        E[i] = e[i] + cand[choice, np.arange(W)]
        T[i] = np.clip(np.arange(W) + choice - 1, 0, W - 1)

    trace = np.zeros(H, np.int64)
    trace[-1] = int(np.argmin(E[-1]))
    for i in range(H - 2, -1, -1):
        trace[i] = T[i + 1, trace[i + 1]]

    out = b2.copy()
    mask = np.zeros(b1.shape, bool)
    cols = np.arange(W)[None, :]
    left = cols < trace[:, None]
    out[left] = b1[left]
    on_seam = cols == trace[:, None]
    out[on_seam] = 0.5 * (b1[on_seam] + b2[on_seam])
    mask[left] = True
    return out, mask


@dataclasses.dataclass
class QuiltingConfig:
    output_size: tuple = (2048, 2048)
    patch_size: int | None = None      # default: texel/4 like the script
    mirror_hor: bool = False
    mirror_vert: bool = False
    strict_match: bool = True          # attenuation 3 vs 1
    close_threshold: float = 1.0       # x patch_length source-distance veto
    coarse_kdtree: bool = True
    max_patch_res: int = 32
    mode: str = "Cut"                  # 'Cut' | 'blend'
    seed: int = 0


class QuiltingSynthesizer:
    """Patch-based texture synthesis on a latent canvas."""

    def __init__(self, patches: np.ndarray, cfg: QuiltingConfig, *,
                 match_dim: int | None = None, sample_tbn=None,
                 picked_vertices=None, patch_length: float | None = None):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.dim = patches.shape[-1]
        self.match_dim = self.dim if match_dim is None else match_dim
        texel = patches.shape[1]
        ps = cfg.patch_size if cfg.patch_size else texel // 4
        if (texel - ps) % 2 == 1:
            ps -= 1
        self.patch_size = ps
        self.overlap = (texel - ps) // 2
        self.attenuation = 3 if cfg.strict_match else 1

        self.n_source = patches.shape[0]
        self.patches, self.sample_tbn = self._augment(
            patches, np.asarray(sample_tbn).reshape(-1, 3, 3)
            if sample_tbn is not None else None)
        self.picked_vertices = picked_vertices
        self.patch_length = patch_length
        if picked_vertices is not None:
            d = picked_vertices[:, None] - picked_vertices[None]
            self.source_dist = np.sqrt((d ** 2).sum(-1))
        else:
            self.source_dist = None

        self._init_canvas()
        self._init_trees()

    # ------------------------------------------------------------------

    def _augment(self, patches, stbn):
        """Mirror augmentation flips the matching sample-TBN axes
        (patch_matching_and_quilting.py:299-317)."""
        out = patches
        tbn = stbn if stbn is not None else np.repeat(
            np.eye(3)[None], len(patches), 0)
        if self.cfg.mirror_hor:
            t2 = tbn.copy()
            t2[..., 0] *= -1
            out = np.concatenate([out, out[:, ::-1]], 0)
            tbn = np.concatenate([tbn, t2], 0)
        if self.cfg.mirror_vert:
            t2 = tbn.copy()
            t2[..., 1] *= -1
            out = np.concatenate([out, out[:, :, ::-1]], 0)
            tbn = np.concatenate([tbn, t2], 0)
        return out, tbn.reshape(-1, 9)

    def _init_canvas(self):
        ps, ov = self.patch_size, self.overlap
        step = ps + ov
        nx = math.ceil((self.cfg.output_size[0] - ov) / step)
        ny = math.ceil((self.cfg.output_size[1] - ov) / step)
        self.grid = (nx, ny)
        size_x = nx * ps + (nx + 1) * ov
        size_y = ny * ps + (nx + 1) * ov
        self.canvas = np.zeros((size_x, size_y, self.dim))
        self.canvas_id = -np.ones(self.canvas.shape[:2])
        self.id_map = -np.ones((nx, ny), np.int64)

    def _cell_span(self, c: int):
        start = (self.patch_size + self.overlap) * c
        return start, start + self.patch_size + 2 * self.overlap

    def _init_trees(self):
        ov, md = self.overlap, self.match_dim
        top = self.patches[:, :ov, :, :md]
        left = self.patches[:, :, :ov, :md]
        if self.cfg.coarse_kdtree:
            b = max(self.patches.shape[1] // self.cfg.max_patch_res, 1)
            self.block = b
            top = block_reduce_mean(top, (1, 1, b, 1))
            left = block_reduce_mean(left, (1, b, 1, 1))
        else:
            self.block = 1
        ft = top.reshape(len(top), -1)
        fl = left.reshape(len(left), -1)
        self.tree_top = cKDTree(ft)
        self.tree_left = cKDTree(fl)
        self.tree_both = cKDTree(np.concatenate([ft, fl], -1))

    # ------------------------------------------------------------------

    def _reduce_strip(self, strip, axis):
        if self.block == 1:
            return strip
        blk = (1, self.block, 1) if axis == 0 else (self.block, 1, 1)
        return block_reduce_mean(strip, blk)

    def _query(self, top, left, k):
        md = self.match_dim
        if top is not None and left is not None:
            q = np.concatenate([
                self._reduce_strip(top[..., :md], 0).ravel(),
                self._reduce_strip(left[..., :md], 1).ravel()])
            return self.tree_both.query(q, k=k)
        if top is not None:
            return self.tree_top.query(
                self._reduce_strip(top[..., :md], 0).ravel(), k=k)
        return self.tree_left.query(
            self._reduce_strip(left[..., :md], 1).ravel(), k=k)

    def _veto(self, dist, ind, row, col):
        """Drop candidates sampled too close on the source surface to a
        placed neighbor (close_patch_check, :203-217); falls back to the
        mirror check when source positions are unknown."""
        keep = np.ones(len(ind), bool)
        for r, c in ((row - 1, col), (row, col - 1)):
            if r < 0 or c < 0 or self.id_map[r, c] < 0:
                continue
            neigh = int(self.id_map[r, c]) % self.n_source
            if self.source_dist is not None:
                thr = self.cfg.close_threshold * (self.patch_length or 0)
                keep &= self.source_dist[ind % self.n_source, neigh] >= thr
            else:
                keep &= np.abs(ind % self.n_source - neigh) >= 1
        return dist[keep], ind[keep]

    def _choose(self, dist, ind):
        p = 1.0 - dist / max(dist.max(), 1e-12)
        p = np.maximum(p, 0)
        if p.sum() <= 0:
            p = np.ones_like(p)
        p = p / p.sum()
        p = p ** self.attenuation
        p = p / p.sum()
        return int(self.rng.choice(ind, p=p))

    def _place(self, pid, row, col):
        ps, ov, md = self.patch_size, self.overlap, self.match_dim
        x0, x1 = self._cell_span(row)
        y0, y1 = self._cell_span(col)
        patch = self.patches[pid].copy()
        patch_id = np.full(patch.shape[:2], pid, float)
        if col > 0:   # left seam
            can = self.canvas[x0:x1, y0:y0 + ov]
            if self.cfg.mode == "Cut":
                stitched, mask = min_error_boundary_cut(
                    can, patch[:, :ov], md)
            else:
                w = (np.arange(ov) / ov)[None, :, None]
                stitched = can * (1 - w) + patch[:, :ov] * w
                mask = np.broadcast_to(w < 0.5, can.shape)
            patch[:, :ov] = stitched
            patch_id[:, :ov] = np.where(
                mask[..., 0], self.canvas_id[x0:x1, y0:y0 + ov], pid)
        if row > 0:   # top seam
            can = self.canvas[x0:x0 + ov, y0:y1]
            if self.cfg.mode == "Cut":
                stitched, mask = min_error_boundary_cut(
                    np.moveaxis(can, 0, 1), np.moveaxis(patch[:ov], 0, 1),
                    md)
                patch[:ov] = np.moveaxis(stitched, 0, 1)
                seam_mask = np.moveaxis(mask[..., 0], 0, 1)
            else:
                w = (np.arange(ov) / ov)[:, None, None]
                patch[:ov] = can * (1 - w) + patch[:ov] * w
                seam_mask = np.broadcast_to(w[..., 0] < 0.5,
                                            can.shape[:2])
            patch_id[:ov] = np.where(seam_mask,
                                     self.canvas_id[x0:x0 + ov, y0:y1],
                                     pid)
        self.canvas[x0:x1, y0:y1] = patch
        self.canvas_id[x0:x1, y0:y1] = patch_id
        self.id_map[row, col] = pid

    # ------------------------------------------------------------------

    def synthesize(self, progress: bool = False):
        nx, ny = self.grid
        first = int(self.rng.integers(0, len(self.patches)))
        self._place(first, 0, 0)
        ov = self.overlap
        for cell in range(1, nx * ny):
            row, col = divmod(cell, ny)
            x0, x1 = self._cell_span(row)
            y0, y1 = self._cell_span(col)
            window = self.canvas[x0:x1, y0:y1]
            top = window[:ov] if row > 0 else None
            left = window[:, :ov] if col > 0 else None
            k = 16
            while True:
                dist, ind = self._query(top, left, min(
                    k, len(self.patches)))
                dist, ind = np.atleast_1d(dist), np.atleast_1d(ind)
                dist, ind = self._veto(dist, ind, row, col)
                if len(ind) or k >= len(self.patches):
                    break
                k *= 2
            if not len(ind):   # every candidate vetoed: allow all
                dist, ind = self._query(top, left,
                                        min(16, len(self.patches)))
                dist, ind = np.atleast_1d(dist), np.atleast_1d(ind)
            self._place(self._choose(dist, ind), row, col)
            if progress and cell % 50 == 0:
                print(f"quilting {cell}/{nx * ny}")
        return self.canvas, self.canvas_id

    # ------------------------------------------------------------------

    def export(self, grid_gap: float, phi_embed_dim: int = 0,
               has_local_tbn: bool = True) -> dict:
        """texture.npz payload (patch_matching_and_quilting.py:485-511)."""
        cid = self.canvas_id.astype(np.int64)
        uniq = np.sort(np.unique(cid.ravel()))
        remap = {int(v): i for i, v in enumerate(uniq)}
        cid_re = np.vectorize(lambda v: remap.get(int(v), 0))(cid)
        md = self.match_dim
        out = {
            "features": self.canvas[..., :md],
            "mesh": None,
            "grid_gap": grid_gap,
            "sample_tbn": self.sample_tbn[uniq.clip(0)],
            "sample_tbn_ids": cid_re,
        }
        out["phi_embed"] = (self.canvas[..., md:md + phi_embed_dim]
                            if phi_embed_dim else None)
        out["local_tbn"] = (self.canvas[..., -9:] if has_local_tbn
                            else None)
        return out
