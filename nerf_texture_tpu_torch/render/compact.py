"""Compacted sample pool (port of ``nerf_texture_tpu/render/compact.py``):
the field runs only where rays have samples.

counts [N] -> exclusive offsets (cumsum) -> each flat slot maps back to
its (ray, sample) -> every pool buffer is a gather from the [N, K] march
result.  Compositing over the pool uses segmented exclusive cumsums
(a global cumsum minus each segment's start), and ``seg_broadcast``, whose
plain backward would be an [M]-row scatter, has a custom backward that
sums segments with a cumsum and two boundary gathers.

``survivor_pool`` is the second-level compaction of the two-phase pool
render: the slots whose compositing weight survives the threshold,
capped per ray, which the colour phase then shades.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.marching import MarchResult


class FlatSamples(NamedTuple):
    ray_id: torch.Tensor   # [M] int64 owning ray (N for padding slots)
    ts: torch.Tensor       # [M]
    dts: torch.Tensor      # [M]
    valid: torch.Tensor    # [M] bool
    offsets: torch.Tensor  # [N + 1] int64 segment bounds (clipped to M)


def flatten_samples(m: MarchResult, budget: int) -> FlatSamples:
    """Compact the valid samples of a march into a [budget] pool.

    Each ray keeps at most ``budget // N`` samples, by strided
    decimation over its whole span with dt scaled by the stride, so the
    pool never overflows and every ray keeps its optical depth."""
    N, K = m.ts.shape
    cap = max(1, budget // N)
    counts = torch.clamp(m.counts, max=cap)
    stride = m.counts.to(m.ts.dtype) / torch.clamp(counts, min=1)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    offsets = torch.clamp(offsets, max=budget)                  # [N + 1]
    slot = torch.arange(budget, device=m.ts.device)
    # owning ray: a +1 marker at every segment start, prefix-summed
    starts = torch.zeros(budget + 1, dtype=torch.int64,
                         device=m.ts.device).index_add_(
        0, offsets[:-1], torch.ones_like(offsets[:-1]))
    ray_id = torch.cumsum(starts[:budget], 0) - 1
    valid = slot < offsets[-1]
    ray_safe = torch.clamp(ray_id, 0, N - 1)
    j = slot - offsets[ray_safe]                     # kept-sample index
    src = torch.floor(j.to(m.ts.dtype) * stride[ray_safe]).to(torch.int64)
    src = torch.clamp(src, 0, K - 1)
    ts = torch.where(valid, m.ts[ray_safe, src], 0.0)
    dts = torch.where(valid, m.dts[ray_safe, src] * stride[ray_safe], 0.0)
    return FlatSamples(ray_id=torch.where(valid, ray_safe, N), ts=ts,
                       dts=dts, valid=valid, offsets=offsets)


def flat_points(rays_o, rays_d, flat: FlatSamples, bound: float):
    """[M, 3] positions (clamped to the AABB) and directions of the pool."""
    rid = torch.clamp(flat.ray_id, 0, rays_o.shape[0] - 1)
    d = rays_d[rid]
    return torch.clamp(rays_o[rid] + flat.ts[:, None] * d, -bound, bound), d


def seg_sum(x, offsets):
    """Sum x [M, ...] over the segments of offsets [N + 1] -> [N, ...].

    The cumsum runs along the last axis of x viewed as [C, M]: PyTorch's
    scan along the leading axis of a narrow [M, C] tensor is C serial
    scans on the card (19 ms a call at M = 262,144, C = 3 on an H100)."""
    xt = x.reshape(x.shape[0], -1).t()                  # [C, M]
    cs = torch.cumsum(xt, dim=-1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=-1)
    out = cs[:, offsets[1:]] - cs[:, offsets[:-1]]      # [C, N]
    return out.t().reshape((offsets.shape[0] - 1,) + x.shape[1:])


class _SegBroadcastFn(torch.autograd.Function):
    """values [N, ...] -> [M, ...] by ray_id, zero on padding slots; the
    backward is a ``seg_sum`` of the masked cotangent."""

    @staticmethod
    def forward(ctx, values, ray_id, offsets):
        N = values.shape[0]
        mask = ray_id < N
        out = values[torch.clamp(ray_id, 0, N - 1)]
        mask = mask.reshape(mask.shape + (1,) * (out.dim() - 1))
        ctx.save_for_backward(mask, offsets)
        return torch.where(mask, out, 0.0)

    @staticmethod
    def backward(ctx, g):
        mask, offsets = ctx.saved_tensors
        return seg_sum(torch.where(mask, g, 0.0), offsets), None, None


seg_broadcast = _SegBroadcastFn.apply


class SurvivorPool(NamedTuple):
    """The pool slots whose weight survives, capped per ray."""

    idx: torch.Tensor      # [M2] source slot in the parent pool
    ray_id: torch.Tensor   # [M2] owning ray (N for padding)
    valid: torch.Tensor    # [M2] bool
    offsets: torch.Tensor  # [N + 1] segment bounds


def survivor_pool(flat: FlatSamples, w, n_rays: int, cap: int,
                  w_eps: float, trans=None,
                  t_eps: float = 1e-4) -> SurvivorPool:
    """Compact the pool slots with weight > w_eps (and transmittance >
    t_eps, the ray-kill threshold), at most ``cap`` per ray, into a pool
    of n_rays * cap slots.

    A ray over its cap keeps its ``cap`` highest weights (in t order;
    the JAX function's ``rank_by_weight``, which no caller turns off):
    the cap-th largest weight of each ray comes
    from a top-k over the dense [N, Kp] view of the pool (flatten_samples
    caps every segment at Kp = M // N, so the view is exact) and only its
    value is used, so ties do not matter; weight ties at the cap are cut
    in t order.  The kept slots are front-compacted by a stable argsort,
    so the result stays segment-contiguous."""
    N = n_rays
    M2 = N * cap
    M = flat.ts.shape[0]
    dev = flat.ts.device
    surv = flat.valid & (w > w_eps)
    if trans is not None:
        surv = surv & (trans > t_eps)
    if M // N > cap:
        Kp = M // N
        col = torch.arange(Kp, device=dev)
        dense_idx = torch.clamp(flat.offsets[:-1, None] + col[None],
                                max=M - 1)
        lens = (flat.offsets[1:] - flat.offsets[:-1])[:, None]
        dense_w = torch.where((col[None] < lens) & surv[dense_idx],
                              w[dense_idx], 0.0)               # [N, Kp]
        kth = torch.topk(dense_w, cap, dim=-1).values[:, -1]   # [N]
        surv = surv & (w >= seg_broadcast(kth, flat.ray_id, flat.offsets))
    si = surv.to(torch.int64)
    # rank of each survivor within its ray (front to back)
    cs = torch.cumsum(si, 0)
    excl = cs - si
    seg_start = torch.cat([cs.new_zeros(1), cs])[flat.offsets[:-1]]  # [N]
    safe = torch.clamp(flat.ray_id, 0, N - 1)
    rank = excl - torch.where(flat.ray_id < N, seg_start[safe], 0)
    keep = surv & (rank < cap)
    counts2 = seg_sum(keep.to(torch.int64), flat.offsets)           # [N]
    offsets2 = torch.clamp(torch.cat([counts2.new_zeros(1),
                                      torch.cumsum(counts2, 0)]), max=M2)
    idx = torch.argsort((~keep).to(torch.uint8), stable=True)[:M2]
    valid2 = torch.arange(idx.shape[0], device=dev) < offsets2[-1]
    ray2 = torch.where(valid2, flat.ray_id[idx], N)
    return SurvivorPool(idx=idx, ray_id=ray2, valid=valid2,
                        offsets=offsets2)


class FlatComposite(NamedTuple):
    image: torch.Tensor        # [N, C]
    depth: torch.Tensor        # [N]
    weights_sum: torch.Tensor  # [N]
    weights: torch.Tensor      # [M]


def flat_weights(sigmas, flat: FlatSamples):
    """Per-sample (weight T * alpha, transmittance T) over the pool."""
    sdt = torch.where(flat.valid, sigmas * flat.dts, 0.0)
    cs = torch.cumsum(sdt, dim=0)
    excl = cs - sdt
    cs_pad = torch.cat([cs.new_zeros(1), cs])
    start = seg_broadcast(cs_pad[flat.offsets[:-1]], flat.ray_id,
                          flat.offsets)
    trans = torch.exp(-(excl - start))
    alpha = 1.0 - torch.exp(-sdt)
    return torch.where(flat.valid, trans * alpha, 0.0), trans


def composite_flat(sigmas, values, flat: FlatSamples) -> FlatComposite:
    """Front-to-back compositing over the pool: sigmas [M], values
    [M, C] -> per-ray image [N, C], depth and opacity [N]."""
    w, _ = flat_weights(sigmas, flat)
    return FlatComposite(image=seg_sum(w[:, None] * values, flat.offsets),
                         depth=seg_sum(w * flat.ts, flat.offsets),
                         weights_sum=seg_sum(w, flat.offsets), weights=w)
