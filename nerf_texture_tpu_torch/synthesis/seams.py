"""Graph-shortest-path seam computation (host numpy / scipy mirror of
``nerf_texture_tpu/synthesis/seams.py``).

An alternative seam finder to the DP cut of ``quilting``: a top-to-bottom
8-connected minimum-error path over the overlap-error graph, allowing
sideways moves, by a single-source Dijkstra from a virtual source joined
to the first row.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra


def floyd_cut(b1: np.ndarray, b2: np.ndarray, match_dim: int | None = None):
    """Seam two overlap strips along a graph-shortest path.

    Args:
      b1, b2: [H, W, C] overlapping strips.

    Returns:
      (stitched [H, W, C], trace [H] seam column per row)
    """
    md = b1.shape[-1] if match_dim is None else match_dim
    e = ((b1[..., :md] - b2[..., :md]) ** 2).sum(-1)
    H, W = e.shape
    n = H * W

    # 8-connected downward/sideways graph with node costs on the target
    rows, cols, data = [], [], []
    idx = np.arange(n).reshape(H, W)
    for dh, dw in ((0, 1), (0, -1), (1, -1), (1, 0), (1, 1)):
        src_h = slice(max(0, -dh), H - max(0, dh))
        src_w = slice(max(0, -dw), W - max(0, dw))
        dst_h = slice(max(0, dh), H - max(0, -dh))
        dst_w = slice(max(0, dw), W - max(0, -dw))
        s = idx[src_h, src_w].ravel()
        t = idx[dst_h, dst_w].ravel()
        rows.append(s)
        cols.append(t)
        data.append(e.ravel()[t])
    # graph + a virtual source (node n) connecting to all row-0 nodes
    g = _with_source(np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(data), e, n, W, idx)

    dist, pred = dijkstra(g, indices=n, return_predecessors=True)
    # best endpoint on the last row
    end = idx[-1][np.argmin(dist[idx[-1]])]
    path = []
    cur = end
    while cur != n and cur >= 0:
        path.append(cur)
        cur = pred[cur]
    path = np.asarray(path[::-1])
    ph, pw = path // W, path % W

    # per-row seam column = first visit of that row
    trace = np.zeros(H, np.int64)
    seen = np.zeros(H, bool)
    for h, w in zip(ph, pw):
        if not seen[h]:
            trace[h] = w
            seen[h] = True
    # fill rows the path skipped sideways (shouldn't happen: path is
    # monotone-ish) with the previous value
    for h in range(1, H):
        if not seen[h]:
            trace[h] = trace[h - 1]

    out = b2.copy()
    cols_grid = np.arange(W)[None, :]
    left = cols_grid < trace[:, None]
    out[left] = b1[left]
    on_seam = cols_grid == trace[:, None]
    out[on_seam] = 0.5 * (b1[on_seam] + b2[on_seam])
    return out, trace


def _with_source(rows, cols, data, e, n, W, idx):
    rows = np.concatenate([rows, np.full(W, n)])
    cols = np.concatenate([cols, idx[0]])
    data = np.concatenate([data, e[0]])
    return csr_matrix((data, (rows, cols)), shape=(n + 1, n + 1))
