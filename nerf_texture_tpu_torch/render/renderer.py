"""Rendering orchestration (port of ``nerf_texture_tpu/render/renderer.py``).

``render_rays`` renders a batch of rays for training: slab test ->
occupancy march -> the compacted sample pool (or the dense [N, K] grid)
-> one field evaluation -> composite.

``render_image`` renders a frame through the proxy path:

  prepass (once per occupancy grid, ``PrepassState``: tight AABB, salt
  filter, dilated occupancy, proxy corner table) ->
  block prepass (one ray per BxB pixel block against the dilated grid,
  tau carve + window refinement under the proxy density) ->
  live compaction (hit blocks first) -> ONE host sync for the live
  count -> a plain loop over chunks of live rays:
  proxy sweep (with ``proxy_samples`` > 0 a coarse round first narrows
  each ray's span to its weight-bearing window) -> survivor selection
  (``proxy_select_cdf`` or ``proxy_select``) -> field on the cap
  survivors -> exact composite -> scatter into the packed frame buffer.

The JAX module's ``jit`` programs, ``lax.while_loop`` and
``frame_one_program`` are TPU dispatch machinery; here they are one
Python loop.  As in JAX, every chunk holds ``ray_chunk`` rays (the last
is padded with the last live ray): the MLPs' GEMM kernels on the card
depend on the row count, and fixed rows keep a ray's result the same
whichever chunk holds it (a band frame is the single-rank frame).  The
``id()``-keyed prepass and corner-table caches become the explicit
``PrepassState`` that the caller builds once per grid.

Without a corner table (``infer_mode='pool'``, or no density grid) a
frame takes the pool path instead: the same block prepass without the
tau carve, then per chunk ``render_rays`` -- the occupancy march within
each ray's prepass span, the compacted sample pool, and with the sigma
and colour functions the two-phase render over ``survivor_pool``.  The
curved model's anchor frames ride along on both paths (``anchor_fn``).

A grid of more than one cascade (a scene of ``bound`` > 1) has no
dilated prepass grid and no corner table: its frames test every pixel's
ray against the occupied AABB and render the hits in chunks through
``render_rays`` (the JAX module's AABB-hit branch).  ``crop_aabb``, the
viewer's inference crop, intersects the occupied AABB on every path; an
empty crop renders pure background.

Deferred (per-ray) shading (``RenderConfig.deferred``; SNeRG, arXiv:
2103.14645) is a branch of the proxy path's tail: with a field's stage
pair ``deferred_apply`` = (s1, s2), stage 1 gives sigma and a flat
feature row a survivor, the composite weights average the rows of each
ray, and stage 2 shades once a ray.  The pool and AABB-hit paths ignore
it, as the JAX module's do, with a warning (``DEFERRED_IGNORED``); a
field whose stage 1 reads anchor frames needs ``anchor_per_sample``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from ..data.rays import get_rays, rotate
from ..ops.composite import composite_rays, composite_with_background
from ..ops.marching import march_rays, near_far_from_aabb, sample_points
from ..ops.proxy_select import (proxy_select, proxy_select_cdf,
                                proxy_select_cdf_reference,
                                proxy_select_reference)
from .compact import (composite_flat, flat_points, flat_weights,
                      flatten_samples, seg_sum, survivor_pool)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Every field of the JAX RenderConfig, so configurations convert;
    see the JAX module for what each one does.  ``proxy_bf16`` stores the
    proxy corner table in bf16, as in JAX; ``frame_one_program``, TPU
    dispatch machinery, is accepted and changes no result."""

    bound: float = 1.0
    cascades: int = 1
    grid_size: int = 128
    min_near: float = 0.2
    density_scale: float = 1.0
    density_thresh: float = 0.01
    dt_gamma: float = 0.0
    max_steps: int = 1024
    max_samples_train: int = 256
    max_samples_infer: int = 512
    ray_chunk: int = 8192
    pool_mean_samples: int = 64
    pool_mean_samples_infer: int = 24
    march_steps_infer: int = 0
    infer_color_cap: int = 8
    infer_w_eps: float = 1e-4
    prepass_block: int = 4
    prepass_margin_steps: float = 1.0
    prepass_thresh_scale: float = 0.5
    prepass_min_component: int = 8
    prepass_strong_alpha: float = 0.01
    prepass_tau_cull: float = 3e-3
    prepass_tau_samples: int = 32
    anchor_per_sample: bool = True
    frame_one_program: bool = True
    deferred: bool = False
    infer_mode: str = "proxy"
    proxy_samples: int = 32
    proxy_refined: int = 24
    proxy_pallas: bool = True
    infer_cdf: bool = True
    proxy_bf16: bool = False

    @staticmethod
    def for_bound(bound: float, **kw) -> "RenderConfig":
        """The config of a scene of this bound: 1 + ceil(log2(bound))
        cascades, the other fields as given or their defaults."""
        cascades = 1 + math.ceil(math.log2(max(bound, 1.0)))
        return RenderConfig(bound=bound, cascades=cascades, **kw)


# the message of each path that renders without the deferred stages it
# was given (one text each, so the default warnings filter shows it once)
DEFERRED_IGNORED = {
    "pool": "render_image: the pool path (infer_mode='pool', or no density "
            "grid) ignores deferred=True and shades every sample",
    "aabb": "render_image: the AABB-hit path (a grid of more than one "
            "cascade) ignores deferred=True and shades every sample",
    "chunks": "render_image_sharded: the chunk-split fallback (no density "
              "grid, the pool path, more than one cascade or a background "
              "image) ignores deferred=True and shades every sample",
}


def _check_deferred(cfg: "RenderConfig", anchor, deferred) -> None:
    """Deferred stage 1 of an anchored field reads each survivor's frames,
    which the proxy tail computes only with ``anchor_per_sample``."""
    if deferred is not None and anchor is not None \
            and not cfg.anchor_per_sample:
        raise ValueError(
            "deferred=True needs anchor_per_sample=True on a field with "
            "anchor frames: the deferred stage 1 reads each survivor's "
            "frames, and anchor_per_sample=False anchors once a ray; set "
            "anchor_per_sample=True or deferred=False")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def render_rays(field_fn, occ, rays_o, rays_d, cfg: RenderConfig, *,
                max_samples: int, perturb: bool = False, u=None,
                bg_color=1.0, aabb=None, pool_mean: int | None = None,
                anchor_fn=None, nears=None, fars=None,
                march_steps: int | None = None, sigma_fn=None,
                color_fn=None, pool_rays: int | None = None,
                pool_hook=None):
    """Render a batch of rays (training, and the pool path of inference).

    field_fn: (xyzs [M, 3], dirs [M, 3][, frames]) -> (sigmas [M],
    rgbs [M, 3]) or (sigmas, rgbs, extras), where the 3-channel extras
    named '*normal*' are alpha-composited too; occ: [cascades *
    grid_size**3] uint8; rays_o / rays_d [N, 3]; bg_color: scalar, [3] or
    [N, 3]; ``perturb`` jitters each ray's start by u [N] in [0, 1) (see
    ``march_rays``).  ``nears`` / ``fars`` [N] (the prepass spans) replace
    the slab test against ``aabb`` (default: the bound's cube);
    ``march_steps`` shortens the march sequence (its step stays tied to
    ``max_steps``).

    anchor_fn(rays_o, rays_d, xs, valid) -> frames (dict of per-point
    tensors): with ``cfg.anchor_per_sample`` it runs on every sample, else
    once per ray at the ray's first sample and is gathered to the
    samples; the field is then called as field_fn(xyzs, dirs, frames).

    With ``pool_mean`` > 0 (default ``cfg.pool_mean_samples``) the field
    runs on the compacted pool of about N * pool_mean samples, else on the
    dense [N, K] grid.  The pool keeps a per-ray cap of budget // N
    samples; ``pool_rays`` sizes the budget for that many rays, so that a
    shorter last chunk keeps the cap of a full one.  With ``sigma_fn``
    (pool only) the render is two-phase: sigma_fn(xyzs, dirs[, frames]) ->
    sigma or (sigma, aux) over the whole pool, ``survivor_pool`` of the
    weights, then color_fn(x2, d2, aux2[, frames2]) -- or field_fn when
    there is no aux -- on the survivors only.  ``pool_hook(flat)``, if
    given, sees the pool (``FlatSamples``) before the field runs (the
    data-parallel step places its rank's slots in the global pool
    there).

    Returns dict(image [N, 3], depth [N], weights_sum [N], counts [N],
    ...composited extras)."""
    if aabb is None:
        aabb = torch.tensor([-cfg.bound] * 3 + [cfg.bound] * 3,
                            dtype=rays_o.dtype, device=rays_o.device)
    if nears is None or fars is None:
        nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)
    m = march_rays(rays_o, rays_d, occ, nears, fars, bound=cfg.bound,
                   cascades=cfg.cascades, grid_size=cfg.grid_size,
                   max_steps=march_steps or cfg.max_steps,
                   max_samples=max_samples, dt_gamma=cfg.dt_gamma,
                   perturb=perturb, u=u, dt_steps=cfg.max_steps)
    N, K = m.ts.shape
    denom = torch.where(fars > nears, fars - nears, 1.0)
    bg = torch.as_tensor(bg_color, dtype=rays_o.dtype, device=rays_o.device)
    per_sample_anchor = anchor_fn is not None and cfg.anchor_per_sample
    frames = None
    if anchor_fn is not None and not per_sample_anchor:
        x_seed = torch.clamp(rays_o + m.ts[:, :1] * rays_d, -cfg.bound,
                             cfg.bound)
        frames = anchor_fn(rays_o, rays_d, x_seed, m.counts > 0)

    if pool_mean is None:
        pool_mean = cfg.pool_mean_samples
    if pool_mean:
        n_pool = pool_rays or N
        budget = _round_up(n_pool * pool_mean, 1024)
        if pool_rays:
            budget = budget // n_pool * N
        flat = flatten_samples(m, budget)
        if pool_hook is not None:
            pool_hook(flat)
        xyzs, dirs = flat_points(rays_o, rays_d, flat, cfg.bound)
        if per_sample_anchor:
            frames_flat = anchor_fn(rays_o, rays_d, xyzs, flat.valid)
        elif frames is not None:
            frames_flat = _take(frames, torch.clamp(flat.ray_id, 0, N - 1))
        else:
            frames_flat = None
        if sigma_fn is not None:
            return _two_phase(field_fn, sigma_fn, color_fn, xyzs, dirs,
                              frames, frames_flat, per_sample_anchor, flat,
                              N, cfg, bg, nears, denom, m.counts)
        sigmas, rgbs, extras = _field_outputs(
            _call(field_fn, frames_flat, xyzs, dirs))
        sigmas = sigmas.reshape(-1) * cfg.density_scale
        res = composite_flat(sigmas, rgbs.reshape(-1, 3), flat)
        results = {"image": res.image + (1.0 - res.weights_sum)[..., None]
                   * bg,
                   "depth": torch.clamp(res.depth - nears, min=0.0) / denom,
                   "weights_sum": res.weights_sum, "counts": m.counts}
        for name, val in extras.items():
            if val is not None and val.shape[-1] == 3 and "normal" in name:
                results[name] = composite_flat(sigmas.detach(),
                                               val.reshape(-1, 3),
                                               flat).image
            else:
                results[name] = val
        return results

    xyzs, dirs = sample_points(rays_o, rays_d, m, cfg.bound)
    xyzs, dirs = xyzs.reshape(N * K, 3), dirs.reshape(N * K, 3)
    if per_sample_anchor:
        frames_d = anchor_fn(rays_o, rays_d, xyzs, m.mask.reshape(-1))
    elif frames is not None:
        frames_d = {k: torch.repeat_interleave(a, K, dim=0)
                    for k, a in frames.items()}
    else:
        frames_d = None
    sigmas, rgbs, extras = _field_outputs(_call(field_fn, frames_d, xyzs,
                                                dirs))
    sigmas = sigmas.reshape(N, K) * cfg.density_scale
    res = composite_rays(sigmas, rgbs.reshape(N, K, 3), m.dts, m.ts, m.mask)
    results = {"image": composite_with_background(res, bg),
               "depth": torch.clamp(res.depth - nears, min=0.0) / denom,
               "weights_sum": res.weights_sum, "counts": m.counts}
    for name, val in extras.items():
        if val is not None and val.shape[-1] == 3 and "normal" in name:
            results[name] = composite_rays(sigmas.detach(),
                                           val.reshape(N, K, 3), m.dts,
                                           m.ts, m.mask).image
        else:
            results[name] = val
    return results


def _call(fn, frames, *args):
    """fn(*args), with the anchor frames as the last argument if any."""
    return fn(*args) if frames is None else fn(*args, frames)


def _take(tree, idx):
    """Rows idx of a tensor or of every tensor of a dict."""
    if isinstance(tree, dict):
        return {k: a[idx] for k, a in tree.items()}
    return tree[idx]


def _field_outputs(out):
    """(sigmas, rgbs, extras dict) of a field's 2- or 3-tuple output."""
    if isinstance(out, tuple) and len(out) == 3:
        return out
    sigmas, rgbs = out
    return sigmas, rgbs, {}


def _two_phase(field_fn, sigma_fn, color_fn, xyzs, dirs, frames,
               frames_flat, per_sample_anchor, flat, N, cfg, bg, nears,
               denom, counts):
    """The two-phase pool render of ``render_rays``: sigma over the whole
    pool -> weights -> ``survivor_pool`` -> colour on the survivors."""
    out1 = _call(sigma_fn, frames_flat, xyzs, dirs)
    sig, aux = out1 if isinstance(out1, tuple) else (out1, None)
    sig = sig.reshape(-1) * cfg.density_scale
    w, trans = flat_weights(sig, flat)
    surv = survivor_pool(flat, w, N, cap=cfg.infer_color_cap,
                         w_eps=cfg.infer_w_eps, trans=trans)
    x2, d2 = xyzs[surv.idx], dirs[surv.idx]
    if per_sample_anchor:
        frames2 = _take(frames_flat, surv.idx)
    elif frames is not None:
        frames2 = _take(frames, torch.clamp(surv.ray_id, 0, N - 1))
    else:
        frames2 = None
    if color_fn is not None and aux is not None:
        aux2 = _take(aux, surv.idx)
        rgb2 = _call(color_fn, frames2, x2, d2, aux2)
    else:
        out = _call(field_fn, frames2, x2, d2)
        rgb2 = out[1] if isinstance(out, tuple) else out
    w2 = torch.where(surv.valid, w[surv.idx], 0.0)
    image = seg_sum(w2[:, None] * rgb2.reshape(-1, 3), surv.offsets)
    wsum = seg_sum(w, flat.offsets)
    dep = seg_sum(w * flat.ts, flat.offsets)
    return {"image": image + (1.0 - wsum)[..., None] * bg,
            "depth": torch.clamp(dep - nears, min=0.0) / denom,
            "weights_sum": wsum, "counts": counts}


# ---------------------------------------------------------------------------
# proposal-style proxy rendering
# ---------------------------------------------------------------------------

def density_corner_table(density: torch.Tensor, grid_size: int,
                         bf16: bool = False) -> torch.Tensor:
    """[H^3] (or [cascades, H^3], cascade 0 used) cell-center densities ->
    [H^3, 8] table whose row r holds the 2x2x2 neighbourhood of cell r
    (edge-clamped at the +1 borders); negative cells clamp to 0.  With
    ``bf16`` the table is stored in bf16 (``RenderConfig.proxy_bf16``);
    ``_proxy_sigma`` casts its rows back to f32 after the gather."""
    H = grid_size
    if density.dim() == 2:
        density = density[0]
    d = torch.clamp(density.reshape(H, H, H), min=0.0)
    ar = torch.arange(H, device=d.device)
    nxt = torch.clamp(ar + 1, max=H - 1)
    rows = []
    for ix in (ar, nxt):
        for iy in (ar, nxt):
            for iz in (ar, nxt):
                rows.append(d[ix][:, iy][:, :, iz].reshape(-1))
    out = torch.stack(rows, dim=-1)                     # [H^3, 8]
    return out.to(torch.bfloat16) if bf16 else out


def _proxy_sigma(dens8: torch.Tensor, rays_o: torch.Tensor,
                 rays_d: torch.Tensor, ts: torch.Tensor, grid_size: int,
                 bound: float) -> torch.Tensor:
    """Trilinear proxy density at o + t d for an [N, K] t-grid."""
    H = grid_size
    inv2b = 1.0 / (2.0 * bound)

    def axis(ax):
        p = rays_o[:, ax:ax + 1] + ts * rays_d[:, ax:ax + 1]
        g = (p * inv2b + 0.5) * H - 0.5
        b = torch.clamp(torch.floor(g), 0.0, H - 2.0)
        return b.to(torch.int64), g - b

    bx, fx = axis(0)
    by, fy = axis(1)
    bz, fz = axis(2)
    base = (bx * H + by) * H + bz                        # [N, K]
    # a bf16 table: cast after the gather
    rows = dens8[base.reshape(-1)].float()               # [N*K, 8]
    wx = torch.stack([1.0 - fx, fx], -1).reshape(-1, 2)
    wy = torch.stack([1.0 - fy, fy], -1).reshape(-1, 2)
    wz = torch.stack([1.0 - fz, fz], -1).reshape(-1, 2)
    w = (wx[:, :, None, None] * wy[:, None, :, None]
         * wz[:, None, None, :]).reshape(-1, 8)
    return torch.sum(rows * w, -1).reshape(ts.shape)


def _proxy_pass(dens8, rays_o, rays_d, t_lo, t_hi, K: int,
                cfg: RenderConfig):
    """K proxy samples at bin centres over [t_lo, t_hi]: (ts [N, K],
    bin width dts [N], weights w [N, K], zero on rays without a span)."""
    span = torch.clamp(t_hi - t_lo, min=0.0)
    dts = span / K
    frac = (torch.arange(K, dtype=rays_o.dtype, device=rays_o.device)
            + 0.5) / K
    ts = t_lo[:, None] + span[:, None] * frac
    sdt = _proxy_sigma(dens8, rays_o, rays_d, ts, cfg.grid_size,
                       cfg.bound) * dts[:, None]
    trans = torch.exp(-(torch.cumsum(sdt, -1) - sdt))
    w = torch.where(span[:, None] > 0, trans * (1.0 - torch.exp(-sdt)), 0.0)
    return ts, dts, w


def render_rays_proxy(field_fn, dens8, rays_o, rays_d, nears, fars,
                      cfg: RenderConfig, *, bg_color=1.0, anchor_fn=None,
                      deferred_fns=None, plain_select: bool = False):
    """Proposal-style inference over each ray's prepass span [nears,
    fars]: K proxy densities -> ``cap`` survivors -> the field on the
    survivors only -> exact composite.  Rays without a span composite to
    pure background.

    Single round (``proxy_samples == 0``): survivors are placed by
    inverse CDF (``infer_cdf``, kernel ``proxy_select_cdf``) or taken as
    the top-``cap`` samples by proxy weight (kernel ``proxy_select``,
    with the dropped samples' optical depth).  ``proxy_pallas=False``
    takes the top-k selection too: the JAX package's XLA chain has the
    Pallas kernel's semantics, and there is no inverse-CDF twin of it (a
    warning says so, as in JAX).

    Two rounds (``proxy_samples`` = K1 > 0): round 1 sweeps K1 samples
    over the span; its active window (weights above max(infer_w_eps,
    1e-4)) widened by two of its steps becomes round 2's span, and rays
    with no active sample render background.  Round 2 takes the top-k
    selection whatever ``infer_cdf`` says (JAX's XLA chain there, which
    ``proxy_select`` computes).

    ``plain_select`` runs the plain PyTorch selections in place of the
    kernels (to hold them against each other).  ``anchor_fn``: as in
    ``render_rays``, on the survivors (see ``_proxy_tail``).
    ``deferred_fns`` (s1, s2): deferred shading on every selection route
    (see ``_proxy_tail``)."""
    _check_deferred(cfg, anchor_fn, deferred_fns)
    K1 = cfg.proxy_samples
    cdf = cfg.infer_cdf and cfg.proxy_pallas and K1 == 0
    if cfg.infer_cdf and not cfg.proxy_pallas and K1 == 0:
        warnings.warn(
            "infer_cdf=True requires proxy_pallas; falling back to the "
            "top-k survivor selection (different sampling algorithm).",
            stacklevel=2)
    if cdf:
        select = proxy_select_cdf_reference if plain_select \
            else proxy_select_cdf
    else:
        select = proxy_select_reference if plain_select else proxy_select
    if K1 == 0:
        t_lo, t_hi = nears, fars
        any_act = fars > nears
    else:
        ts1, dts1, w1 = _proxy_pass(dens8, rays_o, rays_d, nears, fars, K1,
                                    cfg)
        act = w1 > max(cfg.infer_w_eps, 1e-4)
        any_act = torch.any(act, -1)
        first = _first_true(act)
        last = K1 - 1 - _first_true(torch.flip(act, [-1]))
        # a two-step margin: grazing rays' weight tails extend past the
        # active samples
        step1 = 2.0 * dts1
        t_lo = torch.where(any_act, torch.gather(ts1, 1, first[:, None])[:, 0]
                           - step1, nears)
        t_hi = torch.where(any_act, torch.gather(ts1, 1, last[:, None])[:, 0]
                           + step1, nears)
        t_lo = torch.maximum(t_lo, nears)
        t_hi = torch.minimum(t_hi, fars)
    cap, K = cfg.infer_color_cap, cfg.proxy_refined
    span = torch.clamp(t_hi - t_lo, min=0.0)
    dts = span / K
    frac = (torch.arange(K, dtype=rays_o.dtype, device=rays_o.device)
            + 0.5) / K
    ts = t_lo[:, None] + span[:, None] * frac
    sig_p = _proxy_sigma(dens8, rays_o, rays_d, ts, cfg.grid_size,
                         cfg.bound)
    cap_eff = min(cap, K)
    ts2, seg2, valid2 = select(ts, sig_p, t_lo, t_hi, cap=cap_eff,
                               w_eps=float(cfg.infer_w_eps))
    tail = dict(bg_color=bg_color, anchor_fn=anchor_fn, any_act=any_act,
                deferred_fns=deferred_fns)
    if cdf:
        return _proxy_tail(field_fn, rays_o, rays_d, nears, fars, t_lo, dts,
                           ts2, None, valid2, cap_eff, cfg, dt2=seg2, **tail)
    return _proxy_tail(field_fn, rays_o, rays_d, nears, fars, t_lo, dts, ts2,
                       seg2, valid2, cap_eff, cfg, **tail)


def _proxy_tail(field_fn, rays_o, rays_d, nears, fars, t_lo, dts, ts2,
                skip2, valid2, cap_eff: int, cfg: RenderConfig, *, bg_color,
                anchor_fn=None, any_act=None, dt2=None, deferred_fns=None):
    """Exact field eval + front-to-back composite over the [N, cap]
    survivor slots.  Each slot integrates over its segment dt2 (inverse-
    CDF placement) or the bin width dts (top-k); ``skip2`` (top-k only;
    None otherwise) adds the proxy optical depth of the dropped samples
    before each survivor, so the transmittance it sees matches the full
    integral.

    With ``anchor_fn`` the field gets anchor frames: per survivor
    (``anchor_per_sample``; valid where the slot is and the ray has an
    active span, ``any_act``), or once per ray seeded at its first
    survivor (at the middle of the first bin of its span [t_lo, ...]
    when the slot is empty), as training seeds at the first marched
    sample.

    With ``deferred_fns`` = (s1, s2) the shading is deferred to the ray:
    s1(x [M, 3], frames or None) -> (sigma [M], feature rows [M, C]) on
    the survivors (frames only per survivor, with ``anchor_per_sample``:
    as in JAX, no per-ray seed here), the composite weights average each
    ray's rows, and s2(rows [N, C], rays_d) -> rgb [N, 3] shades once a
    ray, weighted by the ray's weights_sum."""
    N = rays_o.shape[0]
    x2 = torch.clamp(rays_o[:, None, :] + ts2[..., None] * rays_d[:, None, :],
                     -cfg.bound, cfg.bound)              # [N, cap, 3]
    d2 = rays_d[:, None, :].expand(x2.shape)
    frames2 = None
    if anchor_fn is not None and cfg.anchor_per_sample:
        frames2 = anchor_fn(rays_o, rays_d, x2.reshape(-1, 3),
                            (valid2 & any_act[:, None]).reshape(-1))
    elif anchor_fn is not None and deferred_fns is None:
        t_seed = torch.where(valid2[:, 0], ts2[:, 0], t_lo + 0.5 * dts)
        x_seed = torch.clamp(rays_o + t_seed[:, None] * rays_d, -cfg.bound,
                             cfg.bound)
        frames = anchor_fn(rays_o, rays_d, x_seed, any_act)
        frames2 = {k: torch.repeat_interleave(a, cap_eff, dim=0)
                   for k, a in frames.items()}
    if deferred_fns is not None:
        out = deferred_fns[0](x2.reshape(-1, 3), frames2)
    else:
        out = _call(field_fn, frames2, x2.reshape(-1, 3), d2.reshape(-1, 3))
    if not isinstance(out, tuple):
        raise ValueError("proxy mode needs field_fn -> (sigma, rgb)")
    sigma2 = out[0].reshape(N, cap_eff) * cfg.density_scale

    seg2 = dts[:, None] if dt2 is None else dt2
    sdt2 = torch.where(valid2, sigma2 * seg2, 0.0)
    cs2 = torch.cumsum(sdt2, dim=-1)
    od2 = cs2 - sdt2
    if skip2 is not None:
        od2 = od2 + torch.where(valid2, skip2, 0.0)
    trans2 = torch.exp(-od2)
    w2 = torch.where(valid2, trans2 * (1.0 - torch.exp(-sdt2)), 0.0)

    wsum = torch.sum(w2, dim=-1)
    if deferred_fns is not None:
        feat = out[1].reshape(N, cap_eff, -1)
        fbar = torch.sum(w2[..., None] * feat, dim=1) \
            / torch.clamp(wsum, min=1e-6)[:, None]
        image = wsum[:, None] * deferred_fns[1](fbar, rays_d)
    else:
        image = torch.sum(w2[..., None] * out[1].reshape(N, cap_eff, 3),
                          dim=1)                         # [N, 3]
    dep = torch.sum(w2 * ts2, dim=-1)
    image = image + (1.0 - wsum)[..., None] * bg_color
    denom = torch.where(fars > nears, fars - nears, 1.0)
    depth = torch.clamp(dep - nears, min=0.0) / denom
    return {"image": image, "depth": depth, "weights_sum": wsum,
            "counts": torch.sum(valid2.to(torch.int32), -1)}


# ---------------------------------------------------------------------------
# prepass: per-grid state (host) and the per-frame block prepass (device)
# ---------------------------------------------------------------------------

def occupied_aabb(occ, grid_size: int, cascades: int, bound: float,
                  margin: float = 0.0):
    """Tight world AABB [6] (np f32) of the occupied cells, clamped to
    [-bound, bound]; None when nothing is occupied (host-side)."""
    g = np.asarray(occ).reshape(cascades, grid_size, grid_size, grid_size)
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for lvl in range(cascades):
        idx = np.argwhere(g[lvl])
        if idx.size == 0:
            continue
        mb = min(2.0 ** lvl, bound)
        lo = np.minimum(lo, (idx.min(0) / grid_size * 2.0 - 1.0) * mb)
        hi = np.maximum(hi, ((idx.max(0) + 1) / grid_size * 2.0 - 1.0) * mb)
    if not np.isfinite(lo).all():
        return None
    return np.concatenate([np.clip(lo - margin, -bound, bound),
                           np.clip(hi + margin, -bound, bound)]
                          ).astype(np.float32)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 when none (what
    jnp.argmax over bool returns)."""
    S = mask.shape[-1]
    ar = torch.arange(S, device=mask.device)
    first = torch.amin(torch.where(mask, ar, S), dim=-1)
    return torch.where(first == S, 0, first)


def _occ_ray_hits(o, d, occ_dil, aabb, bound: float, min_near: float,
                  grid_size: int, n_steps: int = 64,
                  margin_steps: float = 0.0):
    """Coarse ray-vs-occupancy prepass: n_steps points along each ray's
    [near, far] span in the AABB, tested against the DILATED occupancy
    grid (so a thin shell cannot fall between samples).

    Returns (hit [n] bool, t0 [n], t1 [n]): conservative entry/exit of the
    occupied span along each live ray (0 on misses)."""
    H = grid_size
    inv2b = H / (2.0 * bound)
    nears, fars = near_far_from_aabb(o, d, aabb, min_near)
    live = fars > nears
    step = (fars - nears) / n_steps
    frac = (torch.arange(n_steps, dtype=o.dtype, device=o.device)
            + 0.5) / n_steps
    t = nears[:, None] + (fars - nears)[:, None] * frac[None]

    def cl(ax):
        # truncation toward zero, as the JAX .astype(int32)
        v = ((o[:, ax:ax + 1] + t * d[:, ax:ax + 1] + bound)
             * inv2b).to(torch.int32)
        return torch.clamp(v, 0, H - 1).to(torch.int64)

    flat = (cl(0) * H + cl(1)) * H + cl(2)
    occ_s = occ_dil[flat] > 0                             # [n, S]
    hit = live & torch.any(occ_s, dim=-1)
    first = _first_true(occ_s).to(o.dtype)
    last = n_steps - 1 - _first_true(torch.flip(occ_s, [-1])).to(o.dtype)
    t0 = torch.where(hit, torch.maximum(
        nears + (first - margin_steps) * step, nears), 0.0)
    t1 = torch.where(hit, nears + (last + 1.0 + margin_steps) * step, 0.0)
    return hit, t0, t1


def _prepass_salt_filter(occ_np, grid_size: int, min_cells: int,
                         strong_np=None):
    """Morphological opening of the binary PREPASS occupancy (host,
    scipy): components of the eroded grid smaller than ``min_cells`` go,
    3 rounds of reconstruction within the grid re-attach the shaved
    margin, and ``strong_np`` cells are always kept.  Below grid 64 the
    erosion is skipped (it would eat legitimately thin shells)."""
    from scipy import ndimage

    S = np.ones((3, 3, 3), np.uint8)
    g = occ_np.reshape(grid_size, grid_size, grid_size) > 0
    core = ndimage.binary_erosion(g, S) if grid_size >= 64 else g
    labels, n = ndimage.label(core, structure=S)
    if n > 1:
        sizes = np.bincount(labels.reshape(-1))
        sizes[0] = 0
        core = (sizes >= min_cells)[labels] & core
    keep = core
    for _ in range(3):
        keep = ndimage.binary_dilation(keep, S) & g
    if strong_np is not None:
        keep |= strong_np.reshape(g.shape) & g
    return keep.astype(np.uint8).reshape(occ_np.shape)


def _dilate_occ(occ_np, grid_size: int, cascades: int):
    """Host-side 3^3 max-pool of cascade 0 (with wrap-around at the
    borders, as the JAX version)."""
    g = occ_np.reshape(cascades, grid_size, grid_size, grid_size)[0]
    d = g.copy()
    for ax in range(3):
        d = np.maximum(d, np.roll(d, 1, axis=ax))
        d = np.maximum(d, np.roll(d, -1, axis=ax))
    return d.reshape(-1)


def _occ_prepass_arrays(occ, cfg: RenderConfig, density=None):
    """(aabb [6] np or None, dilated occ np or None) of a grid's ``occ``
    and ``density`` tensors (host-side numpy and scipy).

    With the density grid, the PREPASS occupancy uses the stronger
    threshold min(max(march_thresh, prepass_thresh_scale * mean),
    4 march_thresh) and the salt filter, which keep unconverged
    far-field density spikes from making every ray live; the march
    threshold itself stays min(mean, density_thresh)."""
    occ_np = occ.cpu().numpy()
    if density is not None and cfg.cascades == 1:
        dens0_np = density[0].cpu().numpy()
        # the grid's own mean, as the JAX render_image computes it
        mean = float(np.mean(np.clip(dens0_np, 0.0, None)))
        march_thresh = min(mean, cfg.density_thresh)
        pre_thresh = min(max(march_thresh, cfg.prepass_thresh_scale * mean),
                         4.0 * march_thresh)
        occ_np = (dens0_np > pre_thresh).astype(np.uint8)
        cell = 2.0 * cfg.bound / cfg.grid_size
        strong_np = dens0_np > max(cfg.prepass_strong_alpha / cell,
                                   pre_thresh)
    else:
        strong_np = None
    if cfg.prepass_min_component > 1 and cfg.cascades == 1:
        occ_np = _prepass_salt_filter(occ_np, cfg.grid_size,
                                      cfg.prepass_min_component,
                                      strong_np=strong_np)
    aabb_np = occupied_aabb(occ_np, cfg.grid_size, cfg.cascades, cfg.bound,
                            margin=2.0 * cfg.bound / cfg.grid_size)
    occ_dil = (_dilate_occ(occ_np, cfg.grid_size, 1)
               if aabb_np is not None and cfg.cascades == 1 else None)
    return aabb_np, occ_dil


def _tau_samples(cfg: RenderConfig, aabb_np) -> int:
    """Tau-carve sample count scaled to the occupied AABB's diagonal
    (worst-case spacing <= 1.5 cells), quantised to 32s, in [32, 160]."""
    diag = float(np.linalg.norm(aabb_np[3:] - aabb_np[:3]))
    diag_cells = diag * cfg.grid_size / (2.0 * cfg.bound)
    return int(min(160, max(cfg.prepass_tau_samples,
                            32 * math.ceil(diag_cells / 1.5 / 32))))


@dataclasses.dataclass
class PrepassState:
    """What the renderer derives from one occupancy grid, built once per
    grid (the grid changes only on a refresh; frames render many times).

    aabb_np / aabb: tight occupied AABB (np [6] and on the device), None
      when nothing is occupied (pure background);
    occ_dil: [H^3] uint8 dilated prepass occupancy on the device;
    dens8: [H^3, 8] proxy corner table on the device (proxy mode with
      the density grid, bf16 with ``proxy_bf16``; None otherwise, and
      frames take the pool path);
    tau_samples: the tau-carve sample count for this AABB;
    device: where the frame renders;
    occ: the grid's own occupancy, which the pool path marches."""

    aabb_np: np.ndarray | None
    aabb: torch.Tensor | None
    occ_dil: torch.Tensor | None
    dens8: torch.Tensor | None
    tau_samples: int
    device: torch.device
    occ: torch.Tensor | None = None

    @classmethod
    def build(cls, occ, cfg: RenderConfig, *,
              density=None) -> "PrepassState":
        """From the occupancy grid's ``occ`` (and ``density``, which the
        proxy path needs); tensors go to ``occ``'s device."""
        device = occ.device
        aabb_np, occ_dil = _occ_prepass_arrays(occ, cfg, density=density)
        dens8 = None
        if (density is not None and cfg.cascades == 1
                and cfg.infer_mode == "proxy"):
            dens8 = density_corner_table(density, cfg.grid_size,
                                         bf16=cfg.proxy_bf16)
        return cls(
            aabb_np=aabb_np,
            aabb=(None if aabb_np is None
                  else torch.as_tensor(aabb_np, device=device)),
            occ_dil=(None if occ_dil is None
                     else torch.as_tensor(occ_dil, device=device)),
            dens8=dens8,
            tau_samples=(cfg.prepass_tau_samples if aabb_np is None
                         else _tau_samples(cfg, aabb_np)),
            device=device, occ=occ)


def _max3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 neighbourhood max of a 2D map (edge-padded, no wrap-around)."""
    for ax in (0, 1):
        n = x.shape[ax]
        lo = x.index_select(ax, torch.clamp(
            torch.arange(n, device=x.device) - 1, min=0))
        hi = x.index_select(ax, torch.clamp(
            torch.arange(n, device=x.device) + 1, max=n - 1))
        x = torch.maximum(x, torch.maximum(lo, hi))
    return x


def _live_permutation(hit_b: torch.Tensor, *, H: int, W: int, Hb: int,
                      Wb: int, B: int, nb: int):
    """Live-ray compaction: (perm [n] int64 pixel ids, live pixels first;
    count [] live pixels).  Block-aligned frames sort the [nb] block hits
    and expand each block to its B*B pixels (block-grouped order; results
    scatter by pixel id, so no consumer depends on the order)."""
    hits_blk = hit_b[:nb]
    if B > 1 and H % B == 0 and W % B == 0:
        bperm = torch.argsort((~hits_blk).to(torch.uint8), stable=True)
        bi = bperm // Wb
        bj = bperm % Wb
        d = torch.arange(B, device=hit_b.device)
        pix = ((bi[:, None, None] * B + d[None, :, None]) * W
               + bj[:, None, None] * B + d[None, None, :])   # [nb, B, B]
        count = torch.sum(hits_blk.to(torch.int64)) * (B * B)
        return pix.reshape(-1), count
    hits_blk = hits_blk.reshape(Hb, Wb)
    if B > 1:
        hits = torch.repeat_interleave(
            torch.repeat_interleave(hits_blk, B, 0), B, 1)[:H, :W]
    else:
        hits = hits_blk
    hits = hits.reshape(-1)
    perm = torch.argsort((~hits).to(torch.uint8), stable=True)
    return perm, torch.sum(hits.to(torch.int64))


def _prepass_compact(ro_b, rd_b, occ_dil, aabb, bound, min_near, *,
                     grid_size: int, margin_steps: float, H: int, W: int,
                     Hb: int, Wb: int, B: int, nb: int, dens8=None,
                     tau_cull: float = 0.0, tau_samples: int = 32,
                     live_rows: tuple[int, int] | None = None):
    """Block prepass + live compaction on the device.

    With ``dens8`` and ``tau_cull`` > 0, a carve pass drops blocks whose
    whole [t0, t1] span composites below tau_cull alpha under the proxy
    density (3x3 block-neighbourhood max), and refines each block's
    window to the alpha-bearing interval (2-sample margin, 3x3 union).
    The sweep covers the first TAUB = min(4096, nb) hit blocks; blocks
    past the cap keep their full span (warned about once per call site).

    ``live_rows`` (lo, hi): only the block rows lo..hi-1 become live (the
    others are a band's halo, prepassed for the carve's neighbourhoods).

    Returns (perm [n], count [], t0 [nb], t1 [nb], n_hit []): the live
    permutation and count, the block windows, and the number of hit
    blocks before the carve."""
    hit, t0, t1 = _occ_ray_hits(ro_b, rd_b, occ_dil, aabb, bound, min_near,
                                grid_size, margin_steps=margin_steps)
    n_hit = torch.sum(hit.to(torch.int64))
    if dens8 is not None and tau_cull > 0.0 and B > 1:
        K = tau_samples
        TAUB = min(4096, nb)
        bidx = torch.argsort((~hit).to(torch.uint8), stable=True)[:TAUB]
        ro_c, rd_c = ro_b[bidx], rd_b[bidx]
        t0_c, t1_c = t0[bidx], t1[bidx]
        span = torch.clamp(t1_c - t0_c, min=0.0)
        dt = span / K
        frac = (torch.arange(K, dtype=ro_b.dtype, device=ro_b.device)
                + 0.5) / K
        ts = t0_c[:, None] + span[:, None] * frac
        sig = _proxy_sigma(dens8, ro_c, rd_c, ts, grid_size, bound)
        sdt = sig * dt[:, None]
        alpha_c = 1.0 - torch.exp(-torch.sum(sdt, -1))
        covered = torch.zeros((nb,), dtype=torch.bool, device=hit.device)
        covered[bidx] = True
        alpha = torch.zeros((nb,), dtype=ro_b.dtype, device=hit.device)
        alpha[bidx] = alpha_c
        alpha = torch.where(covered, alpha, 1.0)    # uncovered live: keep
        amap = torch.where(hit, alpha, 0.0).reshape(Hb, Wb)
        keep = (_max3x3(amap) > tau_cull).reshape(-1)
        hit = hit & keep
        # window refinement to the alpha-bearing interval
        act = sdt > 1e-4
        any_act_c = torch.any(act, -1)
        first = _first_true(act)
        last = K - 1 - _first_true(torch.flip(act, [-1]))
        t_lo_c = torch.gather(ts, 1, first[:, None])[:, 0] - 2.0 * dt
        t_hi_c = torch.gather(ts, 1, last[:, None])[:, 0] + 2.0 * dt
        t_lo_c = torch.where(any_act_c, t_lo_c, t0_c)
        t_hi_c = torch.where(any_act_c, t_hi_c, t1_c)
        t_lo = t0.clone()
        t_lo[bidx] = t_lo_c
        t_hi = t1.clone()
        t_hi[bidx] = t_hi_c
        big = 3.4e38
        active = torch.zeros((nb,), dtype=torch.bool, device=hit.device)
        active[bidx] = any_act_c
        ok = hit & (active | ~covered)
        lo_map = torch.where(ok, t_lo, big).reshape(Hb, Wb)
        hi_map = torch.where(ok, t_hi, -big).reshape(Hb, Wb)
        lo3 = -_max3x3(-lo_map)
        hi3 = _max3x3(hi_map)
        has_nb = (hi3 > -big).reshape(-1)    # any active ray in 3x3 patch
        t0_r = torch.where(has_nb, torch.maximum(t0, lo3.reshape(-1)), t0)
        t1_r = torch.where(has_nb, torch.minimum(t1, hi3.reshape(-1)), t1)
        t0 = t0_r
        t1 = torch.maximum(t1_r, t0_r)
    if live_rows is not None:
        r = torch.arange(nb, device=hit.device) // Wb
        hit = hit & (r >= live_rows[0]) & (r < live_rows[1])
    perm, count = _live_permutation(hit, H=H, W=W, Hb=Hb, Wb=Wb, B=B, nb=nb)
    return perm, count, t0, t1, n_hit


# ---------------------------------------------------------------------------
# frame loop
# ---------------------------------------------------------------------------

def _frame_buffer_packed(bg, *, n: int, device) -> torch.Tensor:
    """[n, 5] packed frame accumulator (rgb | depth | wsum); the rgb lanes
    start as the background: a scalar, an [3] colour or a full [n, 3]
    image (the NGP's learned background sphere)."""
    bg = torch.as_tensor(bg, dtype=torch.float32, device=device)
    if bg.numel() == 3 * n:
        image = bg.reshape(n, 3)
    else:
        image = bg.reshape(-1).expand(n, 3)
    return torch.cat([image, torch.zeros((n, 2), device=device)], dim=-1)


def _chunk_rays(pose3, intr, idx_c, row0: int, W: int):
    """Chunk rays computed in place from (pose, intrinsics) and pixel ids
    (the math of data.rays.get_rays restricted to the chunk's pixels).
    ``row0`` offsets the pixel rows: the ids count from a band's first
    row."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    i = (idx_c % W).to(torch.float32) + 0.5
    j = (idx_c // W + row0).to(torch.float32) + 0.5
    dirs = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)],
                       dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rd = rotate(dirs, pose3[:, :3])
    ro = pose3[:, 3].expand(rd.shape)
    return ro, rd


def _chunk_body(fns, pose3, intr, frame, perm, count: int, start: int,
                t0_d, t1_d, prepass: PrepassState, cfg: RenderConfig, *,
                B: int, W: int, Wb: int, chunk: int, row0: int = 0,
                plain_select: bool = False) -> torch.Tensor:
    """Gather-render-scatter for the live rays perm[start:start+chunk]:
    the proxy render over the corner table (deferred with ``fns``' stage
    pair), or without one the pool render (march of the grid's occupancy
    within the prepass span, compacted pool, two-phase with ``fns``'
    sigma and colour functions).  Every chunk holds ``chunk`` rays, as
    in the JAX package: the last one is padded with the last live ray
    (``_chunk_rows``), and only its live rows are written back.
    ``frame``'s rgb lanes still hold the background of every unwritten
    ray, so the chunk's bg gather reads it; the frame is updated in place
    and returned."""
    field_fn, anchor_fn, sigma_fn, color_fn, deferred_fns = fns
    idx_c = _chunk_rows(perm, start, chunk, count)
    ro, rd = _chunk_rays(pose3, intr, idx_c, row0, W)
    bg_c = frame[idx_c, :3]
    idx_b = (idx_c // (W * B)) * Wb + (idx_c % W) // B if B > 1 else idx_c
    if prepass.dens8 is not None:
        out = render_rays_proxy(field_fn, prepass.dens8, ro, rd, t0_d[idx_b],
                                t1_d[idx_b], cfg, bg_color=bg_c,
                                anchor_fn=anchor_fn,
                                deferred_fns=deferred_fns,
                                plain_select=plain_select)
    else:
        out = render_rays(
            field_fn, prepass.occ, ro, rd, cfg,
            max_samples=cfg.max_samples_infer, bg_color=bg_c,
            aabb=prepass.aabb, anchor_fn=anchor_fn, nears=t0_d[idx_b],
            fars=t1_d[idx_b], march_steps=cfg.march_steps_infer or None,
            sigma_fn=sigma_fn, color_fn=color_fn,
            pool_mean=(cfg.pool_mean_samples_infer
                       if cfg.pool_mean_samples else 0),
            pool_rays=chunk)
    _write_rows(frame, idx_c, out, count - start)
    return frame


def _chunk_rows(live: torch.Tensor, start: int, chunk: int,
                count: int) -> torch.Tensor:
    """The [chunk] entries live[start:start + chunk] of a list of
    ``count`` live rays (``count`` >= 1), the last chunk padded with the
    last live ray: a chunk's row count never depends on the live count
    (the GEMM kernels of the MLPs on the card do).  A whole chunk is a
    view of ``live``."""
    if start + chunk <= count:
        return live[start:start + chunk]
    return torch.cat([live[start:count],
                      live[count - 1:count].expand(start + chunk - count)])


def _write_rows(frame, idx_c, out, live: int):
    """Scatter a chunk's first ``live`` rows (the rest repeat the last
    live ray) into the packed frame."""
    m = min(live, idx_c.shape[0])
    frame[idx_c[:m]] = torch.cat([out["image"][:m], out["depth"][:m, None],
                                  out["weights_sum"][:m, None]], dim=-1)


def _bind(params, field_static, field_apply, anchor_apply, sigma_apply,
          color_apply, deferred_apply=None):
    """The per-point functions of a frame: (field_fn, anchor_fn, sigma_fn,
    color_fn, deferred_fns) with params and field_static bound; with
    ``anchor_apply`` the field functions take the anchor frames as their
    last argument.  deferred_fns: None, or the stage pair (s1(x, frames),
    s2(fbar, d)) of ``deferred_apply`` = (s1(params, x, field_static,
    frames), s2(params, fbar, d, field_static))."""
    st = field_static
    dfn = None
    if deferred_apply is not None:
        s1, s2 = deferred_apply
        dfn = (lambda x, f: s1(params, x, st, f),
               lambda fb, d: s2(params, fb, d, st))
    if anchor_apply is not None:
        return (lambda x, d, f: field_apply(params, x, d, st, f),
                lambda o, d, xs, sv: anchor_apply(params, o, d, xs, sv, st),
                None if sigma_apply is None else
                (lambda x, d, f: sigma_apply(params, x, d, st, f)),
                None if color_apply is None else
                (lambda x, d, a, f: color_apply(params, x, d, a, st, f)),
                dfn)
    return (lambda x, d: field_apply(params, x, d, st), None,
            None if sigma_apply is None else
            (lambda x, d: sigma_apply(params, x, d, st)),
            None if color_apply is None else
            (lambda x, d, a: color_apply(params, x, d, a, st)), dfn)


def _crop(prepass: PrepassState, crop_aabb, cfg: RenderConfig):
    """(aabb np, aabb tensor, tau samples) of the prepass's occupied AABB
    intersected with the user's ``crop_aabb`` [6]; (None, None, ...)
    when the crop leaves nothing."""
    if crop_aabb is None or prepass.aabb_np is None:
        return prepass.aabb_np, prepass.aabb, prepass.tau_samples
    crop = np.asarray(crop_aabb, np.float32)
    a = prepass.aabb_np
    aabb_np = np.concatenate([np.maximum(a[:3], crop[:3]),
                              np.minimum(a[3:], crop[3:])])
    if (aabb_np[3:] <= aabb_np[:3]).any():
        return None, None, prepass.tau_samples
    return (aabb_np, torch.as_tensor(aabb_np, device=prepass.device),
            _tau_samples(cfg, aabb_np))


def _render_aabb_hits(fns, frame, pose, intr, aabb, prepass: PrepassState,
                      cfg: RenderConfig, *, H: int, W: int, chunk: int):
    """The frame of a grid without a dilated prepass grid (more than one
    cascade): every pixel's ray against the occupied AABB, one host sync
    for the hit count, then the hits in pixel order in chunks of
    ``chunk`` rays (the last padded with the last hit, as in JAX) through
    ``render_rays`` (the pool path; its slab test clamps each ray to the
    AABB).  Returns
    (frame, live rays, chunks)."""
    field_fn, anchor_fn, sigma_fn, color_fn, _ = fns
    rays = get_rays(pose, intr, H, W)
    nears, fars = near_far_from_aabb(rays["rays_o"], rays["rays_d"], aabb,
                                     0.0)
    live = torch.nonzero(fars > nears)[:, 0]
    count = int(live.numel())
    n_chunks = -(-count // chunk)
    for c in range(n_chunks):
        idx_c = _chunk_rows(live, c * chunk, chunk, count)
        out = render_rays(
            field_fn, prepass.occ, rays["rays_o"][idx_c],
            rays["rays_d"][idx_c], cfg, max_samples=cfg.max_samples_infer,
            bg_color=frame[idx_c, :3], aabb=aabb, anchor_fn=anchor_fn,
            march_steps=cfg.march_steps_infer or None, sigma_fn=sigma_fn,
            color_fn=color_fn,
            pool_mean=(cfg.pool_mean_samples_infer
                       if cfg.pool_mean_samples else 0),
            pool_rays=chunk)
        _write_rows(frame, idx_c, out, count - c * chunk)
    return frame, count, n_chunks


def render_image(field_apply, field_static, params, prepass: PrepassState,
                 pose, intrinsics, H: int, W: int, cfg: RenderConfig, *,
                 bg_color=1.0, anchor_apply=None, sigma_apply=None,
                 color_apply=None, crop_aabb=None, deferred_apply=None,
                 plain_select: bool = False, row0: int = 0,
                 frame_rows: int | None = None):
    """Render a full frame: block prepass, live compaction, one host sync
    for the live count, then a plain loop over chunks of live rays.

    field_apply(params, xyzs [M, 3], dirs [M, 3], field_static[,
    frames]) -> (sigmas [M], rgbs [M, 3]); anchor_apply(params, rays_o,
    rays_d, xs, valid, field_static) -> frames; sigma_apply(params, x, d,
    field_static[, frames]) -> (sigma, aux) and color_apply(params, x, d,
    aux, field_static[, frames]) -> rgb, the two phases of the pool path.
    ``prepass`` is the grid's ``PrepassState``: with a corner table
    (``infer_mode='proxy'``) the frame takes the proxy path, without one
    the pool path (no tau carve in the block prepass), and without a
    dilated grid (more than one cascade) the AABB-hit path.
    ``crop_aabb`` [6] (xmin, ymin, zmin, xmax, ymax, zmax), the inference
    crop, is intersected with the occupied AABB.  ``bg_color``: a scalar,
    an [3] colour or an [H * W, 3] image, what a ray that composites no
    weight shows.  ``plain_select``: see ``render_rays_proxy``.
    ``deferred_apply`` (s1(params, x, field_static, frames) -> (sigma,
    feature rows), s2(params, fbar, d, field_static) -> rgb): deferred
    shading on the proxy path when given (the caller passes it when
    ``cfg.deferred``); the pool and AABB-hit paths ignore it with a
    warning (``DEFERRED_IGNORED``), and with ``anchor_apply`` it needs
    ``cfg.anchor_per_sample`` (a ``ValueError`` otherwise).
    With ``frame_rows`` (the height of a frame of one cascade), one band
    of it: the H rows from pixel row ``row0`` on (a multiple of
    ``prepass_block``), through the band's own block prepass and chunk
    loop (``parallel.eval``'s scanline bands; a scalar or [3]
    ``bg_color``).  The block rows next to the band within the frame
    join its block prepass but are not rendered, so that the tau carve's
    3x3 block neighbourhoods at the band's edges are the whole frame's.

    Returns dict(image [H, W, 3], depth [H, W], weights_sum [H, W],
    live: live rays rendered, chunks: chunks rendered)."""
    _check_deferred(cfg, anchor_apply, deferred_apply)
    if deferred_apply is not None and prepass.dens8 is None:
        warnings.warn(DEFERRED_IGNORED["aabb" if prepass.occ_dil is None
                                       else "pool"])
    device = prepass.device
    n = H * W
    chunk = min(cfg.ray_chunk, n)
    frame = _frame_buffer_packed(bg_color, n=n, device=device)

    def out(frame, live, chunks):
        return {"image": frame[:, :3].reshape(H, W, 3),
                "depth": frame[:, 3].reshape(H, W),
                "weights_sum": frame[:, 4].reshape(H, W),
                "live": live, "chunks": chunks}

    aabb_np, aabb, tau_samples = _crop(prepass, crop_aabb, cfg)
    if aabb_np is None:
        return out(frame, 0, 0)         # nothing occupied: pure background
    pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
    intr_np = np.asarray(intrinsics, np.float32)
    intr = torch.as_tensor(intr_np, device=device)
    fns = _bind(params, field_static, field_apply, anchor_apply,
                sigma_apply, color_apply, deferred_apply)
    if prepass.occ_dil is None:
        if frame_rows is not None:
            raise ValueError("render_image: a band needs a grid of one "
                             "cascade")
        return out(*_render_aabb_hits(fns, frame, pose, intr, aabb, prepass,
                                      cfg, H=H, W=W, chunk=chunk))
    B = max(1, cfg.prepass_block)
    if row0 % B:
        raise ValueError(f"render_image: a band's first row {row0} is not a "
                         f"multiple of the prepass block {B}")
    Hb, Wb = -(-H // B), -(-W // B)
    # a band's neighbour block rows within the frame (prepassed only)
    top = below = 0
    if frame_rows is not None:
        top = min(1, row0 // B)
        below = max(0, min(1, -(-frame_rows // B) - row0 // B - Hb))
    if top or below:
        frame = _frame_buffer_packed(bg_color, n=(H + (top + below) * B) * W,
                                     device=device)
    nb = (Hb + top + below) * Wb
    rb0 = row0 // B - top
    rays_b = get_rays(pose, torch.as_tensor(intr_np / B, device=device),
                      rb0 + Hb + top + below, Wb)
    rays_b = {k: v[rb0 * Wb:] for k, v in rays_b.items()}
    perm, count_d, t0_d, t1_d, n_hit_d = _prepass_compact(
        rays_b["rays_o"], rays_b["rays_d"], prepass.occ_dil, aabb,
        cfg.bound, cfg.min_near, grid_size=cfg.grid_size,
        margin_steps=(cfg.prepass_margin_steps if B > 1 else 0.0),
        H=H + (top + below) * B, W=W, Hb=Hb + top + below, Wb=Wb, B=B,
        nb=nb, dens8=prepass.dens8, tau_cull=cfg.prepass_tau_cull,
        tau_samples=tau_samples,
        live_rows=(top, top + Hb) if top or below else None)
    # the frame's one host sync: the live count (and the hit-block count
    # for the tau-sweep cap warning) in one transfer
    count, n_hit = torch.stack([count_d, n_hit_d]).tolist()
    if (prepass.dens8 is not None and cfg.prepass_tau_cull > 0.0 and B > 1
            and n_hit > 4096):
        # one message text, so the default filter shows it once
        warnings.warn(
            "render_image: the hit blocks exceed the tau sweep's cap of "
            "4096; the blocks past it keep their full span (ROADMAP "
            "Queue 3)", stacklevel=2)
    n_chunks = -(-count // chunk)
    for c in range(n_chunks):
        frame = _chunk_body(fns, pose[:3], intr, frame, perm, count,
                            c * chunk, t0_d, t1_d, prepass, cfg, B=B, W=W,
                            Wb=Wb, chunk=chunk, row0=row0 - top * B,
                            plain_select=plain_select)
    return out(frame[top * B * W:top * B * W + n], count, n_chunks)
