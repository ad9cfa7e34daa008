"""The minimum s-t cut of GrabCut's graph: an 8-connected H x W grid of
nodes, each with one net terminal weight.

Replaces ``GCGraph::maxFlow`` (OpenCV's Boykov-Kolmogorov max-flow) as
``cv2.grabCut`` runs it, through ``nerf_texture_tpu/data/segmenter.py``
and ``nerf_texture_tpu/data/prepare.py``.  It replaces no TPU kernel: the
JAX package calls OpenCV on the host.

The graph: ``cap[k, y, x]`` is the capacity of the edge from node (y, x)
to its neighbour in direction ``DIRS[k]`` (0 where that neighbour lies
off the grid); ``weight[y, x]`` is the node's net terminal weight as
``GCGraph::addTermWeights`` folds a source and a sink weight into one
(> 0: from the source, < 0: to the sink).  The result is the source side
of a minimum cut: the nodes that cannot reach the sink in the residual
graph of a maximum flow (a residual of at most ``TOL`` counts as
saturated).  That set is the same for every maximum flow.  Where the
minimum cut is unique OpenCV's cut is the same set, and the two agree
(bit for bit on the tests' frames); where several cuts tie (a flat
region whose pixels weigh 0), ``GCGraph`` labels the nodes that neither
tree holds at the end by the tree they last belonged to, which follows
Boykov-Kolmogorov's growth order: there both cuts are minimal but may
differ.

The algorithm (the same phases in the CUDA kernel and in the plain
version): push-relabel in float64 on the grid.  A global relabel sets
every height to the node's distance to the sink in the residual graph
(n = H * W when it cannot reach it); it stops when no node with excess
has a height below n.  Else up to ``RELABEL_EVERY`` sweeps follow, each
of three phases: push (every active node sends what it can to the sink
and down its admissible edges, in direction order, writing what it
sends), apply (every node gathers what its neighbours sent it, in
direction order: no float atomics, so two runs give the same cut),
relabel (an active node with no admissible edge takes one more than its
lowest residual neighbour, into a second height buffer).  The batch ends
early once no node is active (the preflow is maximal; a further sweep
would change nothing), and only the sweeps that ran are counted.

On a CUDA tensor ``min_cut`` launches the kernel in ``csrc/maxflow.cu``
(built at first use, see ``kernels.py``) and counts the launch, or
raises; on a CPU tensor it runs ``min_cut_reference``, the plain PyTorch
version, which is also the kernel's oracle on the card.  The kernel's
global relabel relaxes heights tile by tile to the same distances the
plain version's level-synchronous BFS finds (they are unique), so the two
compute the same flow and the same cut.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import load_library

# (dy, dx) of the 8 directions; the opposite of k is (k + 4) % 8
DIRS = ((0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0),
        (1, -1))
RELABEL_EVERY = 32      # sweeps between two global relabels
MAX_SWEEPS = 1 << 22    # a cut that has not ended by then raises
# A residual capacity at or below TOL counts as saturated.  Push-relabel
# leaves an edge that a sequence of partial pushes saturates with a few
# ulps (7e-15 on a capacity of 50 is one) where Boykov-Kolmogorov's
# augmentation leaves exactly 0, and a few such edges on the cut would
# let a whole region reach the sink; GrabCut's capacities are 1e-3 to
# ~1e3, so 1e-12 is ~10 ulps of the largest and below any capacity that
# can move the cut's energy.
TOL = 1e-12


def grid_capacities(left: torch.Tensor, upleft: torch.Tensor,
                    up: torch.Tensor, upright: torch.Tensor) -> torch.Tensor:
    """cap [8, H, W] of GrabCut's N-links: ``left[y, x]`` joins (y, x) and
    (y, x - 1), ``upleft`` (y - 1, x - 1), ``up`` (y - 1, x), ``upright``
    (y - 1, x + 1), each with the same capacity both ways (``addEdges(i,
    j, w, w)``); entries whose neighbour is off the grid are ignored."""
    H, W = left.shape
    cap = left.new_zeros((8, H, W))
    cap[0, :, 1:] = left[:, 1:]
    cap[4, :, :-1] = left[:, 1:]
    cap[1, 1:, 1:] = upleft[1:, 1:]
    cap[5, :-1, :-1] = upleft[1:, 1:]
    cap[2, 1:, :] = up[1:, :]
    cap[6, :-1, :] = up[1:, :]
    cap[3, 1:, :-1] = upright[1:, :-1]
    cap[7, :-1, 1:] = upright[1:, :-1]
    return cap


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx] of direction k, ``fill``
    off the grid."""
    dy, dx = DIRS[k]
    H, W = x.shape[-2:]
    out = torch.full_like(x, fill)
    ys, yd = (slice(dy, H), slice(0, H - dy)) if dy >= 0 else \
        (slice(0, H + dy), slice(-dy, H))
    xs, xd = (slice(dx, W), slice(0, W - dx)) if dx >= 0 else \
        (slice(0, W + dx), slice(-dx, W))
    out[..., yd, xd] = x[..., ys, xs]
    return out


def _global_relabel(c: torch.Tensor, rs: torch.Tensor, n: int):
    """Heights = each node's distance to the sink in the residual graph
    (sink-adjacent nodes 1), n where it cannot reach the sink: a
    level-synchronous BFS from the sink."""
    h = torch.full(rs.shape, n, dtype=torch.int32, device=rs.device)
    frontier = rs > TOL
    h[frontier] = 1
    level = 1
    while bool(frontier.any()):
        nxt = torch.zeros_like(frontier)
        for k in range(8):
            nxt |= (c[k] > TOL) & _shift(frontier, k, False)
        nxt &= h == n
        level += 1
        h[nxt] = level
        frontier = nxt
    return h


def _sweep(c, e, rs, h, n: int):
    """One push / apply / relabel sweep; returns (c, e, rs, h)."""
    # push: what each active node sends, in direction order
    act = (e > 0) & (h < n)
    to_sink = torch.where(act & (h == 1) & (rs > TOL),
                          torch.minimum(e, rs), 0.0)
    rs = rs - to_sink
    rem = e - to_sink
    hn = [_shift(h, k, -1) for k in range(8)]
    out = []
    for k in range(8):
        adm = act & (rem > 0) & (c[k] > TOL) & (hn[k] == h - 1)
        o = torch.where(adm, torch.minimum(rem, c[k]), 0.0)
        rem = rem - o
        out.append(o)
    # apply: every node gathers what its neighbours sent it
    e = rem
    cs = []
    for k in range(8):
        inflow = _shift(out[(k + 4) % 8], k, 0.0)
        e = e + inflow
        cs.append(c[k] - out[k] + inflow)
    c = torch.stack(cs)
    # relabel: active nodes without an admissible edge, into a new buffer
    act = (e > 0) & (h < n)
    adm = (h == 1) & (rs > TOL)
    low = torch.where(rs > TOL, 0, n)
    for k in range(8):
        res = c[k] > TOL
        adm |= res & (hn[k] == h - 1)
        low = torch.where(res, torch.minimum(low, hn[k].clamp(min=0)), low)
    lift = act & ~adm
    h = torch.where(lift, torch.clamp(low + 1, max=n), h).to(torch.int32)
    return c, e, rs, h


def min_cut_reference(cap: torch.Tensor, weight: torch.Tensor):
    """Plain PyTorch ``min_cut``: (source side bool [H, W], stats dict with
    the sweeps and global relabels it took)."""
    H, W = weight.shape
    n = H * W
    c = cap.to(torch.float64).clone()
    e = torch.clamp(weight.to(torch.float64), min=0.0)
    rs = torch.clamp(-weight.to(torch.float64), min=0.0)
    sweeps = relabels = queued = 0
    while True:
        h = _global_relabel(c, rs, n)
        relabels += 1
        if not bool(((e > 0) & (h < n)).any()):
            break
        if queued >= MAX_SWEEPS:
            raise RuntimeError(f"min_cut: no end after {queued} sweeps")
        for _ in range(RELABEL_EVERY):
            if not bool(((e > 0) & (h < n)).any()):
                break
            c, e, rs, h = _sweep(c, e, rs, h, n)
            sweeps += 1
        queued += RELABEL_EVERY
    return h >= n, {"sweeps": sweeps, "relabels": relabels}


def cut_energy(cap: torch.Tensor, weight: torch.Tensor,
               source: torch.Tensor) -> float:
    """The float64 capacity of the cut that puts ``source`` on the source
    side: N-links from a source node to a sink node, the source weight of
    every sink-side node, the sink weight of every source-side node."""
    w = weight.to(torch.float64)
    total = torch.where(source, torch.clamp(-w, min=0.0),
                        torch.clamp(w, min=0.0)).sum()
    for k in range(8):
        across = source & ~_shift(source, k, True)
        total = total + torch.where(across, cap[k].to(torch.float64),
                                    0.0).sum()
    return float(total)


@functools.cache
def _lib():
    lib = load_library("maxflow")
    lib.maxflow_grid.restype = ctypes.c_int
    lib.maxflow_grid.argtypes = ([ctypes.c_void_p] * 10
                                 + [ctypes.c_int] * 4
                                 + [ctypes.c_void_p, ctypes.c_void_p])
    return lib


def min_cut(cap: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The source side (bool [H, W]) of a minimum cut of the grid graph
    ``cap`` [8, H, W], ``weight`` [H, W] (float64).  On the card: the
    hand-written kernel, one entry point that queues its CUDA launches
    itself, counted once a cut in ``min_cut.launches`` (its CUDA launches
    in ``min_cut.cuda_launches``); on the CPU the plain version.  Either
    way the cut's sweeps and global relabels are in ``min_cut.last_stats``
    and added to ``min_cut.sweeps`` and ``min_cut.relabels``."""
    if cap.dim() != 3 or cap.shape[0] != 8 or cap.shape[1:] != weight.shape:
        raise ValueError(f"min_cut: cap {tuple(cap.shape)} and weight "
                         f"{tuple(weight.shape)} are not [8, H, W], [H, W]")
    if cap.device.type == "cpu":
        source, stats = min_cut_reference(cap, weight)
        _record(stats)
        return source
    if cap.device.type != "cuda" or weight.device != cap.device:
        raise ValueError(f"min_cut: cap on {cap.device}, weight on "
                         f"{weight.device}")
    if cap.dtype != torch.float64 or weight.dtype != torch.float64:
        raise ValueError("min_cut: cap and weight must be float64")
    H, W = weight.shape
    cap = cap.contiguous()
    weight = weight.contiguous()
    dev = cap.device
    c = torch.empty_like(cap)
    out = torch.empty_like(cap)
    e = torch.empty_like(weight)
    rs = torch.empty_like(weight)
    h = torch.empty((2, H, W), dtype=torch.int32, device=dev)
    flags = torch.zeros(4, dtype=torch.int32, device=dev)
    source = torch.empty((H, W), dtype=torch.uint8, device=dev)
    stats = (ctypes.c_int * 3)()
    err = _lib().maxflow_grid(
        cap.data_ptr(), weight.data_ptr(), c.data_ptr(), out.data_ptr(),
        e.data_ptr(), rs.data_ptr(), h[0].data_ptr(), h[1].data_ptr(),
        flags.data_ptr(), source.data_ptr(), H, W, RELABEL_EVERY,
        MAX_SWEEPS, ctypes.cast(stats, ctypes.c_void_p),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"maxflow_grid failed: "
                           f"{'no end after MAX_SWEEPS sweeps' if err == -1 else f'CUDA error {err}'}")
    min_cut.launches += 1
    min_cut.cuda_launches += stats[2]
    _record({"sweeps": stats[0], "relabels": stats[1]})
    return source.bool()


def _record(stats: dict):
    min_cut.last_stats = stats
    min_cut.sweeps += stats["sweeps"]
    min_cut.relabels += stats["relabels"]


min_cut.launches = min_cut.cuda_launches = 0
min_cut.sweeps = min_cut.relabels = 0
min_cut.last_stats = {"sweeps": 0, "relabels": 0}
