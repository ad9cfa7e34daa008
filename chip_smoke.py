#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port ``nerf_texture_tpu_torch`` on a GPU.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls, and
checks them: at the width of ``bench.py``'s NGP arm the serving path
(``train.trainer.render_frame`` of an 800x800 novel view) over seeded
weights and the training path (``train.trainer.Trainer``: ``train``,
``eval_psnr``, ``render_frame``), whose trained field is rendered through
both survivor selections; at the width of its curved arm the curved
model's serving path (``CurvedTrainer.initialize_states`` and
``render_frame``, live and ``parity=True``) over seeded weights, and its
training path (``CurvedTrainer.train``, 700 steps), whose trained field
is rendered live, through the pool and through the baked atlas
(``bake_atlas``, ``render_frame(baked=True)``); then the texture
pipelines on that trained field: the flat one (patch export, quilting,
the 'field' and 'patch' imports) and the synthesis onto another mesh
with the 'shape' and 'unhash' imports (``field_io``).
Phases, in order; any failure ends the run with a non-zero exit and no
result line:

  1. device:  a CUDA card is required (there is no CPU path); prints the
              card's name and power limit as nvidia-smi gives them;
  2. build:   builds the selection kernels from csrc/ (nvcc, sm_90a) and
              prints ptxas's register and spill lines;
  3. kernel:  proxy_select_cdf vs its plain PyTorch version on the card,
              at the serving path's shape [16384, 24] cap 4 and at
              [8192, 16] cap 5, with degenerate spans, empty rays and
              ties; times the plain version;
  4. parity:  a small frame rendered by the port on the card vs the same
              frame by the port on the CPU (whose numerics the tier-1 tests
              hold against the JAX package);
  5. slice:   seeded full-width NGP params over a fixture density shell,
              800x800 frames at novel orbit poses: shape, range, live
              count, kernel launches == chunks, and one frame re-rendered
              with the plain selection agrees;
  6. kernel:  proxy_select (top-k) vs its plain version at the trained
              render's shape [16384, 24] cap 8 and at [8192, 32] cap 8 and
              [8192, 16] cap 4, same recipe;
  7. train:   Trainer on SyntheticSphereDataset(8 frames, 800x800) for
              50 + 650 steps: the loss is finite and falls, the grid is
              not empty;
  8. render:  the trained field: training-view and novel-view PSNR with
              the bench selection (inverse CDF, cap 4) and with top-k
              (cap 8), ms/frame of both, launches == chunks for each
              kernel, and a top-k frame re-rendered with the plain
              selection agrees; ``field_io.save_mesh`` of its density at
              256^3 (main_nerf.py's export) lies on the dataset's sphere;
  9. curved:  the NeRF-Texture curved model at the width of bench.py's
              curved arm (``train.curved_trainer.CurvedTrainer`` over
              make_icosphere(4, 0.5), seeded weights): the host set-up
              (projector, near cells, anchor table), initialize_states(1),
              proxy_select_cdf vs plain at [16384, 24] cap 5, live 800x800
              frames through the kernel (launches == chunks, and a frame
              re-rendered with the plain selection agrees), parity=True
              pool frames, kernels a frame from one torch.profiler frame
              of each, and a small frame of both paths on the card vs the
              CPU port;
 10. curved train: proxy_select_cdf vs plain at the baked render's
              shapes [16384, 16] cap 5 and [16384, 20] cap 6; then
              CurvedTrainer at the same width from seeded weights with
              bench.py's schedule (initialize_states(1), 17 + 48 timed +
              635 steps): the loss is finite, it/s, one profiled step,
              s per refresh, peak memory; the trained field at the novel
              pose: live, pool and EMA parity frames, the bake, baked
              frames at cap 5 K 16 and cap 6 K 20 -- each PSNR gated at
              the JAX package's cell less 1 dB, the live and baked frames
              held against their plain-selection frames, launches ==
              chunks, ms/frame over 3 poses; the live field at the baked
              arm's settings (K 16, cap 5), beside the baked frame;
 11. texture: the flat texture pipeline on phase 10's trained field:
              ``field_io.save_field`` exports 256 patches of 128^2 texels
              (ray cast, exact projection, encode), ``QuiltingSynthesizer``
              quilts a 2048^2 canvas on the host, ``load_field`` imports
              it (mode 'field', 50 grid refreshes over the z = 0 slab)
              and 800x800 frames look down onto it through
              proxy_select_cdf and, with ``proxy_samples=32``, through
              the two-round proxy and proxy_select; ``load_patch``
              imports one patch (mode 'patch') and frames look at it --
              each path's launches == chunks, ms/frame over 3 poses, one
              profiled frame, and a frame re-rendered with the plain
              selection agrees; then the narrow curved config on the
              card and on the CPU port imports the same texture.npz
              (the CPU's export, quilted) and one patch, and their 64x64
              frames agree;
 12. surfaces: phase 11's patches synthesised onto another mesh (a
              rounded box, 512^2 UV map; the curved-synthesis CLI's
              function, with an iteration cap), then on the trained
              field ``load_field`` + ``load_shape`` (the flat texture
              wrapped onto the box), ``load_unhash`` (the synthesised
              texture) and ``unhash`` (the trained field baked into the
              subdivided template's 163,842 vertices), each with 800x800
              frames through proxy_select_cdf (launches == chunks, a
              plain-selection frame agrees, one profiled frame and the
              share of the uvh / barycentric queries), the unhash
              frame's PSNR, a take_photo PNG; then the narrow config on
              the card and on the CPU port imports one CPU-written
              curved_mesh.npz and bakes one unhash, and their 64x64
              frames agree;
 13. timing:  each selection kernel's device time from torch.profiler's
              kernel events (median of 60 launches; cold with 64 MiB
              written between launches, and warm with sig just written),
              against its bound and beside a copy_ of the same bytes,
              and its wrapper's host time a call, at [16384, 24] CDF cap
              5 and cap 4 and top-k cap 8.

Prints a ``{"kernels": [...]}`` JSON line before the last, and as the last
line ``{"ok": true, "device": {...}}``.  Needs one card, the CUDA toolkit
(nvcc) and no network; the kernel build goes to build/kernels/, the
texture files to build/texture/, the surface files to build/surfaces/.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances (each with its reason):
# kernel vs plain selection: t values within 1e-5 (float summation order
# may differ in the last bits; the kernel compiles with --fmad=false and
# the same scan association, so it usually agrees exactly); valid equal.
# The inverse CDF maps a quantile u to t through the bin holding it, so
# an error e of the normalised CDF moves t by dts * e / w, w the bin's
# share of the ray's weight: where a quantile falls in a nearly empty
# bin, a one-ulp CDF difference (6e-8 near 1) moves t by more than 1e-5
# (measured 1.56e-5 in a bin holding 7.8e-5 of the weight).  There a CDF
# slot is held in CDF space instead: within CDF_ATOL (16 ulps near 1).
SELECT_ATOL = 1e-5
CDF_ATOL = 1e-6
# a frame on the card vs on the CPU: bf16 rounding of the MLP activations
# and of the table products can fall differently after a last-bit
# difference in f32 sums, and a prepass hit test on a cell border can
# flip a block; the same bounds as the JAX-parity test of the slice.
FRAME_PSNR_MIN = 45.0
FRAME_MAX_ABS = 5e-2
FRAME_LIVE_MISMATCH = 0.005
# kernel frame vs plain-selection frame on the card: the kernels round
# as the plain versions do, so the frames are expected equal.  Should
# the selections part by an ulp, a quantile whose ray's CDF plateaus (an
# empty gap between the front and back crossings of the shell) at a
# level within rounding of u jumps across the gap in one version only,
# and a few pixels differ by up to a sample's contribution: the bounds
# are on the frame's PSNR, its largest difference and the share of
# pixels that differ by more than 1e-3.
TWIN_FRAME_PSNR_MIN = 60.0
TWIN_FRAME_MAX_ABS = 5e-2
TWIN_FRAME_OFF_SHARE = 1e-3
# trained field: the JAX package's cells after the same 700 steps
# (BENCH_r05.json: 27.07 dB on training view 0, 23.94 dB on the novel
# view), less about 1 dB for the port's other random streams.
TRAIN_PSNR_MIN = 26.0
NOVEL_PSNR_MIN = 23.0
JAX_TRAIN_PSNR, JAX_NOVEL_PSNR = 27.07, 23.94

# Kernel timing (phase 13): the selection kernels at the main path's
# shapes -- the curved live chunk (CDF cap 5), the NGP renders (CDF cap 4)
# and the NGP top-k render (cap 8) -- each over TIMED_LAUNCHES launches.
# Bounds use the H100 SXM's published rates (NVIDIA's data sheet, 700 W):
# HBM3 3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores.
TIMED_SHAPES = [("cdf", 16384, 24, 5), ("cdf", 16384, 24, 4),
                ("topk", 16384, 24, 8)]
TIMED_LAUNCHES = 60
WRAPPER_CALLS, WRAPPER_BATCHES = 100, 5
FLUSH_BYTES = 64 << 20
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

BENCH_NGP = dict(bound=1.0, num_levels=8, level_dim=4, log2_bricks=16,
                 desired_resolution=2048)
# RenderConfig of bench.py's NGP arm
BENCH_RENDER = dict(bound=1.0, cascades=1, grid_size=128, max_steps=384,
                    max_samples_train=192, max_samples_infer=96,
                    ray_chunk=16384, pool_mean_samples=64,
                    pool_mean_samples_infer=24, proxy_samples=0,
                    proxy_refined=24, infer_color_cap=4, prepass_block=8,
                    prepass_tau_cull=0.1)
# TrainConfig of bench.py's NGP arm, and its 50 + 650 steps
BENCH_TRAIN = dict(lr=1e-2, total_steps=2000, num_rays=4096, grid_decay=0.85)
WARM_STEPS, TRAIN_STEPS = 50, 650
SMALL_NGP = dict(bound=1.0, num_levels=4, level_dim=4, log2_bricks=10,
                 desired_resolution=256)
SMALL_RENDER = dict(bound=1.0, cascades=1, grid_size=32, ray_chunk=1024,
                    proxy_samples=0, proxy_refined=24, infer_color_cap=4,
                    prepass_block=8, prepass_tau_cull=0.1)
# U(-1e-4, 1e-4) init tables give features ~1e-4 and a flat sigma ~1;
# scaled by 1e4 the seeded field has sigma from ~0.1 to ~10 and varied
# colour, so the frame composites real structure.
TABLE_SCALE = 1e4


# bench.py's curved arm (bench.py:340-367): MeshFieldConfig() defaults,
# the SH light, its RenderConfig and CurvedTrainConfig
CURVED_RENDER = dict(bound=1.0, cascades=1, grid_size=128, max_steps=512,
                     max_samples_train=128, max_samples_infer=96,
                     ray_chunk=16384, pool_mean_samples=64,
                     pool_mean_samples_infer=24, march_steps_infer=256,
                     proxy_samples=0, proxy_refined=24, infer_color_cap=5)
CURVED_TRAIN = dict(lr=1e-2, total_steps=4000, num_rays=4096,
                    grid_update_interval=16, grid_full_updates=0)
# host counts of this mesh and grid (compute_near_cells and the anchor
# table's cKDTree prefilter)
NEAR_CELLS, ANCHOR_CELLS = 398104, 885224
# the small card-vs-CPU curved frame: a narrow field over
# make_icosphere(2, 0.5), grid 32, 64x64
SMALL_FIELD = dict(num_levels=4, level_dim=2, base_resolution=32,
                   desired_resolution=64, log2_bricks=12, h_threshold=0.1)
SMALL_CURVED_RENDER = dict(bound=1.0, cascades=1, grid_size=32,
                           max_steps=128, max_samples_infer=48,
                           ray_chunk=1024, pool_mean_samples_infer=16,
                           proxy_samples=0, proxy_refined=24,
                           infer_color_cap=5)
# bench.py's curved schedule (bench.py:368-385): 17 steps, 48 timed
# steps (3 refresh cycles), the rest to 700
CURVED_WARM_STEPS, CURVED_TIMED_STEPS, CURVED_TRAIN_STEPS = 17, 48, 700
# its baked render (bench.py:455-476): cap 5 K 16 over the block-8 carve,
# then the cap 6 K 20 quality line; the selection kernel at those chunks
CURVED_BAKED = dict(prepass_block=8, prepass_tau_cull=0.1, proxy_refined=16)
CURVED_BAKED_CAP6 = dict(infer_color_cap=6, proxy_refined=20)
BAKED_SHAPES = [(16384, 16, 5), (16384, 20, 6)]
# the JAX package's curved cells after the same 700 steps (BENCH_r05.json)
# and the gates: each less 1 dB for the port's other random streams (the
# margin of the NGP gates); the EMA parity frame also keeps the bench's
# own absolute gate of 24 dB
JAX_CURVED_PSNR = {"live": 26.65, "pool": 26.59, "ema_parity": 26.63,
                   "baked": 26.43, "baked_cap6": 27.16}
CURVED_PSNR_MIN = {k: round(v - 1.0, 2) for k, v in JAX_CURVED_PSNR.items()}
# the texture pipeline (phase 11) at PatchSampleConfig's shapes (128^2
# texels, pattern rate 1/50, 16 centres a batch) with the patch budget
# cut from 2000 to 256, quilted at QuiltingConfig's 2048^2 canvas; the
# narrow card-vs-CPU export: 16^2 texels, 8 patches, a 64^2 canvas
TEXTURE_PATCHES, TEXTURE_SIZE = 256, 2048
TEXTURE_DIR = os.path.join("build", "texture")
SMALL_TEXTURE = dict(patch_size=16, max_patch_num=8, center_batch=4,
                     pattern_rate=1 / 4)
SMALL_TEXTURE_SIZE = 64
# the two-round proxy: RenderConfig's default proxy_samples
TWO_ROUND = dict(proxy_samples=32)
# phase 8's mesh export: main_nerf.py's save_mesh at resolution 256 and
# sigma 10 of the trained NGP; the sphere of the dataset has radius 0.5.
# The sigma-10 set holds floaters of the untrained regions too (a first
# run: 418,530 vertices, mean |r - 0.5| 0.126), so the gate is on the
# sphere being there: >= 90% of 2,000 points spread over it within 0.03
# of a vertex (two cells of the 128^3 training grid: the sigma-10 level
# may sit that far off the surface the rays saw)
NGP_MESH_RES = 256
NGP_MESH_PROBES, NGP_MESH_TOL, NGP_MESH_COVER = 2000, 0.03, 0.9
# the surfaces (phase 12): the target mesh, a rounded box of 24,578
# vertices (make_box subdivided to >= 10,000 vertices, 8 laplacian
# steps); the curved synthesis of phase 11's patches onto its 512^2 UV
# map, cut to fit the smoke: the grid gap 4e-3 in place of the CLI's
# 5e-4 (a patch covers 64x the area) and at most 40 iterations (0.7-1.1
# s each on the card's host, scripts/torch_curved_synthesis.py; 60 set
# 60.8% of the texels), which must set at least SURFACE_MIN_DONE of
# them; unhash at field_io's default of 100,000 vertices
SURFACE_DIR = os.path.join("build", "surfaces")
SURFACE_BOX, SURFACE_MIN_VERTICES, SURFACE_SMOOTH = (0.5, 0.35, 0.25), \
    10000, 8
SURFACE_RES = 512
SURFACE_GAP, SURFACE_ITERS = 4e-3, 40
SURFACE_MIN_DONE = 0.3
UNHASH_MIN_VERTICES = 100000
# the narrow card-vs-CPU check of phase 12: phase 11's narrow files, the
# target subdivided to >= 600 vertices, a 64^2 UV map, unhash to >= 2000
# vertices
SMALL_SURFACE = dict(min_vertices=600, resolution=64, grid_gap=0.04,
                     max_iters=60)
SMALL_UNHASH_VERTICES = 2000
# seeded curved params: the encoder's mean lanes are U(-1e-4, 1e-4) and
# the phi grid U(0, 1e-3) at init; scaled by 1e4 and 1e3 the features
# and the fine normals vary and the field has structure
PHI_SCALE = 1e3


def surface_target(min_vertices: int = SURFACE_MIN_VERTICES):
    """The smoke's target mesh for the surface imports: a rounded box
    (``make_box(SURFACE_BOX)`` subdivided to ``min_vertices``, smoothed)."""
    from nerf_texture_tpu_torch.geometry.mesh import make_box
    from nerf_texture_tpu_torch.geometry.shape_tools import (
        laplacian_smooth, subdivide_to)

    return laplacian_smooth(subdivide_to(make_box(SURFACE_BOX), min_vertices),
                            SURFACE_SMOOTH)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a - b) ** 2))
    return 99.0 if mse <= 1e-12 else -10.0 * float(np.log10(mse))


def cuda_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def selection_inputs(N: int, K: int, seed: int, dev):
    """Seeded [N, K] proxy densities with degenerate spans, empty rays and
    ties (the CPU test's recipe)."""
    rng = np.random.default_rng(seed)
    t_lo = rng.uniform(0.5, 1.5, N).astype(np.float32)
    t_hi = t_lo + rng.uniform(0.0, 1.0, N).astype(np.float32)
    t_hi[: N // 4] = t_lo[: N // 4]
    sig = rng.gamma(0.5, 4.0, (N, K)).astype(np.float32)
    sig[N // 4: N // 2] = 0.0
    sig[N // 2: N // 2 + 4] = 3.0
    frac = (np.arange(K, dtype=np.float32) + 0.5) / K
    ts = t_lo[:, None] + np.maximum(t_hi - t_lo, 0.0)[:, None] * frac
    return [torch.from_numpy(a).to(dev) for a in (ts, sig, t_lo, t_hi)]


def cdf_slack(args, ts2, valid2):
    """Per CDF slot [N, cap], the t error that a CDF_ATOL error of the
    normalised CDF makes in the bin where the plain version put it, at
    most one bin width; 0 on rays without weight (valid2 False)."""
    from nerf_texture_tpu_torch.ops.proxy_select import cumsum_lanes

    _, sig, t_lo, t_hi = args
    K = sig.shape[1]
    dts = torch.clamp(t_hi - t_lo, min=0.0)[:, None] / K
    sdt = sig * dts
    w = torch.exp(-(cumsum_lanes(sdt) - sdt)) * (1.0 - torch.exp(-sdt))
    share = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    b = torch.floor((ts2 - t_lo[:, None]) / torch.clamp(dts, min=1e-30))
    share = torch.gather(share, 1, torch.clamp(b.long(), 0, K - 1))
    slack = torch.minimum(dts * CDF_ATOL / torch.clamp(share, min=1e-12),
                          dts)
    return torch.where(valid2, slack, 0.0)


def check_selection(name, got, ref, N, K, cap, zero_unfilled, args=None):
    """Kernel outputs vs the plain version's: t values within SELECT_ATOL
    (with ``args``, the inverse CDF's inputs, a slot may instead agree
    within CDF_ATOL in CDF space; see the tolerances), valid equal, and
    (top-k) zeros in unfilled slots; returns the max abs error in t."""
    err = max(float((got[i] - ref[i]).abs().max()) for i in (0, 1))
    slack = torch.full_like(ref[0], SELECT_ATOL)
    if args is not None:
        slack = torch.maximum(slack, cdf_slack(args, ref[0], ref[2]))
    # a gap dt2[c] moves with the slots at both of its ends
    slack_dt = torch.maximum(slack, torch.cat([slack[:, 1:], slack[:, -1:]],
                                              dim=1))
    ok = bool(((got[0] - ref[0]).abs() <= slack).all()
              and ((got[1] - ref[1]).abs() <= slack_dt).all())
    check(ok, f"{name} kernel vs plain at [{N}, {K}] cap {cap}: max abs "
          f"err {err} beyond {SELECT_ATOL} (or CDF_ATOL in CDF space)")
    check(bool(torch.equal(got[2], ref[2])),
          f"{name} kernel vs plain valid2 differ at [{N}, {K}] cap {cap}")
    if zero_unfilled:
        off = ~got[2]
        check(bool((got[0][off] == 0).all() and (got[1][off] == 0).all()),
              f"{name}: unfilled slots not zero at [{N}, {K}] cap {cap}")
    return err


def seeded_params(ngp, mcfg, generator):
    params = ngp.init(generator, mcfg)
    params["grid"] = params["grid"] * TABLE_SCALE
    return params


def frame_checks(out, H, W, name):
    img = out["image"]
    check(tuple(img.shape) == (H, W, 3), f"{name}: image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), f"{name}: non-finite pixels")
    check(float(img.min()) >= 0.0, f"{name}: negative pixels")
    check(0 < out["live"] < H * W, f"{name}: live rays {out['live']}")
    check(float(out["weights_sum"].max()) > 0.05,
          f"{name}: no pixel composites any weight")


def check_twin(name, img_k, img_p, card):
    """A kernel frame against its plain-selection frame: PSNR, max abs
    and the share of pixels off by > 1e-3, held to the TWIN_FRAME_*
    limits."""
    t_psnr, t_err = psnr(img_p, img_k), float(np.abs(img_p - img_k).max())
    t_off = float(np.mean(np.abs(img_p - img_k).max(-1) > 1e-3))
    print(f"{name}: kernel frame vs plain-selection frame: PSNR "
          f"{t_psnr:.2f} dB, max abs {t_err:.3g}, pixels off by > 1e-3: "
          f"{t_off:.2e} ({card})")
    check(t_psnr >= TWIN_FRAME_PSNR_MIN and t_err <= TWIN_FRAME_MAX_ABS
          and t_off <= TWIN_FRAME_OFF_SHARE,
          f"{name} kernel frame vs plain-selection frame: PSNR {t_psnr} dB, "
          f"max abs {t_err}, share off {t_off}")


def kernel_events(fn, cats=("kernel",)):
    """(name, device us) of every CUDA kernel that one call of fn runs,
    under torch.profiler, from the trace's ``cat == "kernel"`` events
    (annotation rows would count a kernel twice); ``cats`` may add
    "gpu_memcpy" for copies."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [(e.get("name", ""), float(e.get("dur", 0.0))) for e in events
            if e.get("cat") in cats]


def profile_frame(fn):
    """(CUDA kernels, their device ms) of one call of fn."""
    kernels = kernel_events(fn)
    return len(kernels), sum(d for _, d in kernels) / 1e3


def select_bound(kind: str, N: int, K: int, cap: int):
    """(bound ms, "bytes" or "operations", bytes) of one selection call:
    the
    larger of its bytes -- each input read once (sig, and ts for top-k;
    t_lo, t_hi), each output written once (two f32 rows and a bool row of
    cap) -- over HBM_BYTES_PER_S and its f32 operations over
    F32_OPS_PER_S.  Operations count the plain algorithm's: per sample a
    multiply, two Hillis-Steele scans (log2 K adds each), two exp, a few
    subtracts and selects, and (CDF) a divide or (top-k) two compares a
    round; per CDF quantile K compares and ~10 ops."""
    n_in = 2 if kind == "topk" else 1
    nbytes = N * K * 4 * n_in + 2 * N * 4 + N * cap * 9
    lg = int(np.ceil(np.log2(max(K, 2))))
    if kind == "topk":
        ops = N * K * (2 * lg + 8 + 2 * cap)
    else:
        ops = N * (K * (2 * lg + 8) + cap * (K + 10))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return ((t_bytes, "bytes", nbytes) if t_bytes >= t_ops
            else (t_ops, "operations", nbytes))


def time_select(select, args, cap: int, flush) -> dict:
    """Device and host times of one selection wrapper at one shape.

    device_us_warm: median device duration of the selection kernel over
    TIMED_LAUNCHES launches, each right after sig is rewritten (so sig
    sits in L2, as _proxy_sigma leaves it on the render path);
    device_us: the same with ``flush`` (64 MiB, more than the 50 MB L2)
    written before each launch, so the inputs come from HBM -- the
    reading compared with the bound; wrapper_us: host time of a call of
    the wrapper (checks, outputs, launch): the median over WRAPPER_BATCHES
    batches of the mean of WRAPPER_CALLS back-to-back calls, which the
    card runs faster than the host issues them."""
    sig = args[1]
    src = sig.clone()
    name = re.compile(r"select(_cdf|_topk)?_kernel")

    def run(before):
        def go():
            for i in range(TIMED_LAUNCHES):
                before(i)
                select(*args, cap=cap, w_eps=1e-4)
        durs = traced_durations(go, lambda n: name.search(n), ("kernel",),
                                "selection kernels")
        return float(np.median(durs)), len(durs)

    select(*args, cap=cap, w_eps=1e-4)                 # warm-up
    warm, n_warm = run(lambda i: sig.copy_(src))
    cold, n_cold = run(lambda i: flush.fill_(float(i)))
    host = []
    for _ in range(WRAPPER_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WRAPPER_CALLS):
            select(*args, cap=cap, w_eps=1e-4)
        host.append((time.perf_counter() - t0) / WRAPPER_CALLS * 1e6)
    torch.cuda.synchronize()
    return {"device_us": cold, "device_us_warm": warm,
            "wrapper_us": float(np.median(host)),
            "traced": min(n_cold, n_warm)}


def traced_durations(go, pick, cats, what: str) -> list[float]:
    """Device durations (us) of the kernels ``pick`` selects by name in
    a trace of go(), which launches TIMED_LAUNCHES of them.  After the
    curved training phase the trace has been seen to miss some kernel
    records (35 and 57 of 60), so the fullest of three traces is taken
    and must hold at least half of the launches."""
    best: list[float] = []
    for _ in range(3):
        durs = [d for n, d in kernel_events(go, cats) if pick(n)]
        if len(durs) > len(best):
            best = durs
        if len(best) == TIMED_LAUNCHES:
            break
    check(TIMED_LAUNCHES // 2 <= len(best) <= TIMED_LAUNCHES,
          f"{len(best)} {what} traced for {TIMED_LAUNCHES} launches")
    return best


def copy_floor_us(nbytes: int, flush, dev) -> float:
    """Median device time (us) of one Tensor.copy_ that reads and writes
    nbytes / 2 bytes each -- the same traffic as the kernel's -- cold, as
    time_select times it: what one pass over these bytes costs on this
    card at this size, launch and DRAM latency included."""
    src = torch.empty(nbytes // 8, device=dev)
    dst = torch.empty_like(src)

    def go():
        for i in range(TIMED_LAUNCHES):
            flush.fill_(float(i))
            dst.copy_(src)
    durs = traced_durations(go, lambda n: "fill" not in n.lower(),
                            ("kernel", "gpu_memcpy"), "copies")
    return float(np.median(durs))


def timing_phase(dev, card: str) -> dict:
    """Phase 13: device time of both selection kernels at the main path's
    shapes against their bounds, and the wrappers' host time."""
    from nerf_texture_tpu_torch.ops import proxy_select as ops

    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    out = {}
    for seed, (kind, N, K, cap) in enumerate(TIMED_SHAPES):
        args = selection_inputs(N, K, 30 + seed, dev)
        fname = "proxy_select" if kind == "topk" else "proxy_select_cdf"
        res = time_select(getattr(ops, fname), args, cap, flush)
        bound_ms, bound_by, nbytes = select_bound(kind, N, K, cap)
        res.update(bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms * 1e3 / res["device_us"],
                   copy_us=copy_floor_us(nbytes, flush, dev))
        out[(kind, N, K, cap)] = res
        print(f"timing: {fname} [{N}, {K}] cap {cap}: kernel "
              f"{res['device_us']:.2f} us cold (HBM), "
              f"{res['device_us_warm']:.2f} us warm (L2); bound "
              f"{bound_ms * 1e3:.3f} us by {bound_by}, "
              f"{100 * res['bound_share']:.1f}% of it cold; a copy_ of "
              f"the same bytes {res['copy_us']:.2f} us; wrapper "
              f"{res['wrapper_us']:.2f} us a call (median of "
              f"{res['traced']} or more of {TIMED_LAUNCHES} launches "
              f"traced, torch.profiler) ({card})")
    del flush
    torch.cuda.empty_cache()
    return out


def seeded_curved(trainer, table_scale: float):
    """Scale the seeded curved params (see PHI_SCALE) and render them."""
    field = trainer.state.params["field"]
    rw = trainer.ccfg.field.feature_spec.row_width
    with torch.no_grad():                # the params are trainable leaves
        field["encoder"][:, :rw] *= table_scale
        field["normal"]["phi_grid"] *= PHI_SCALE
    trainer.state.ema_params = trainer.state.params


def curved_phase(dev, card: str, ds, timing: dict) -> dict:
    """Phase 9: the curved serving path; returns the kernel launches of
    its live frames and the selection error at its shape."""
    from scipy.spatial import cKDTree

    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.ops.proxy_select import (
        proxy_select_cdf, proxy_select_cdf_reference)
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)

    # The normal net's Lipschitz MLPs and the SH products multiply f32
    # operands, which TF32 would round: full f32 for the curved frames.
    torch.backends.cuda.matmul.allow_tf32 = False
    H = W = ds.H
    ccfg = CurvedFieldConfig(field=MeshFieldConfig(), light_model="SH")
    rcfg = RenderConfig(**CURVED_RENDER)
    tcfg = CurvedTrainConfig(**CURVED_TRAIN)

    # -- host set-up ----------------------------------------------------
    t0 = time.perf_counter()
    mesh = make_icosphere(4, radius=0.5)
    mp = MeshProjector(mesh, device=dev)
    proj_s = time.perf_counter() - t0
    tr = CurvedTrainer(ds, mesh_field.make_state(mp), ccfg, rcfg, tcfg,
                       seed=7, device=dev)
    seeded_curved(tr, TABLE_SCALE)
    t0 = time.perf_counter()
    near = tr._get_near_cells()
    near_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tab = tr._anchor_table()
    torch.cuda.synchronize()
    tab_s = time.perf_counter() - t0
    cell = 2.0 * rcfg.bound / rcfg.grid_size
    G = rcfg.grid_size
    c = (np.arange(G) + 0.5) / G * 2.0 - 1.0
    d, _ = cKDTree(mp.arrays.vertices.cpu().numpy()).query(
        np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3),
        workers=-1)
    prefilter = int(np.sum(d < 4.0 * ccfg.field.h_threshold + 2.0 * cell))
    spec = ccfg.field.feature_spec
    print(f"curved: {len(mesh.vertices)} vertices, {len(mesh.faces)} faces "
          f"({mp.arrays.vertices.shape[0]} after the UV atlas); hash "
          f"{spec.num_levels} levels x {spec.level_dim}, "
          f"{spec.table_rows} x {spec.dual_storage_width} dual table; "
          f"grid {G}^3")
    print(f"curved: set-up: MeshProjector {proj_s:.2f} s, near cells "
          f"{near.shape[0]} in {near_s:.2f} s, anchor table over "
          f"{prefilter} cells in {tab_s:.2f} s "
          f"({int((tab[..., 15] > 0.5).sum())} hit) ({card})")
    check(near.shape[0] == NEAR_CELLS, f"near cells {near.shape[0]}")
    check(prefilter == ANCHOR_CELLS, f"anchor prefilter {prefilter}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.initialize_states(1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    occupied = int(tr.state.occ.occ.sum())
    print(f"curved: initialize_states(1) in {init_s:.3f} s; {occupied} of "
          f"{G ** 3} cells occupied ({card})")
    check(0 < occupied < G ** 3, f"occupied cells {occupied}")

    # -- the kernel at this slice's shape --------------------------------
    N, K, cap = rcfg.ray_chunk, rcfg.proxy_refined, rcfg.infer_color_cap
    args = selection_inputs(N, K, 20, dev)
    got = proxy_select_cdf(*args, cap=cap, w_eps=1e-4)
    ref = proxy_select_cdf_reference(*args, cap=cap, w_eps=1e-4)
    torch.cuda.synchronize()
    err = check_selection("proxy_select_cdf", got, ref, N, K, cap,
                          zero_unfilled=False, args=args)
    plain = cuda_ms(lambda: proxy_select_cdf_reference(*args, cap=cap,
                                                       w_eps=1e-4))
    timing[(N, K, cap)] = plain
    print(f"kernel: proxy_select_cdf [{N}, {K}] cap {cap}: max abs err "
          f"{err:.3g}; plain version {plain * 1e3:.2f} us a call ({card})")

    # -- live and pool frames ---------------------------------------------
    poses = [orbit_pose(1.25 + 0.1 * i, 2 * np.pi * (i + 0.5) / 8, 2.0)
             for i in range(4)]
    stats = {}
    for name, parity in (("live", False), ("pool", True)):
        tr.render_frame(poses[0], parity=parity)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = proxy_select_cdf.launches
        walls, outs = [], []
        for pose in poses[1:]:
            t0 = time.perf_counter()
            outs.append(tr.render_frame(pose, parity=parity))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = proxy_select_cdf.launches - before
        chunks = sum(o["chunks"] for o in outs)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        for o in outs:
            frame_checks(o, H, W, f"curved {name}")
        if parity:
            check(launches == 0, f"the pool path launched {launches} "
                  f"selection kernels")
        else:
            check(launches > 0 and launches == chunks,
                  f"curved live: {launches} kernel launches for {chunks} "
                  f"chunks")
        n_k, k_ms = profile_frame(lambda: tr.render_frame(poses[1],
                                                          parity=parity))
        stats[name] = dict(walls=walls, outs=outs, launches=launches,
                           chunks=chunks, peak=peak, kernels=n_k,
                           kernel_ms=k_ms)
    live = stats["live"]
    img_k = live["outs"][0]["image"].cpu().numpy()
    img_p = tr.render_frame(poses[1], plain_select=True)["image"].cpu().numpy()
    check_twin("curved: live", img_k, img_p, card)
    p_lp = psnr(stats["pool"]["outs"][0]["image"].cpu().numpy(), img_k)
    for name in ("live", "pool"):
        st = stats[name]
        print(f"curved: {name} {H}x{W}: "
              f"{', '.join(f'{w:.2f}' for w in st['walls'])} ms/frame "
              f"(median {float(np.median(st['walls'])):.2f}) over "
              f"{len(st['walls'])} novel poses; live rays "
              f"{[o['live'] for o in st['outs']]}; chunks/frame "
              f"{[o['chunks'] for o in st['outs']]}; proxy_select_cdf "
              f"launches {st['launches']}; peak memory {st['peak']:.1f} "
              f"MiB; one profiled frame: {st['kernels']} CUDA kernels, "
              f"{st['kernel_ms']:.2f} ms of kernel time ({card})")
    print(f"curved: pool frame vs live frame at the same pose: PSNR "
          f"{p_lp:.2f} dB (seeded weights; not a quality gate) ({card})")

    # -- a small frame on the card vs the CPU port -------------------------
    small = {}
    for name, dev_i in (("cpu", torch.device("cpu")), ("cuda", dev)):
        ccfg_s = CurvedFieldConfig(field=MeshFieldConfig(**SMALL_FIELD),
                                   light_model="SH")
        ds_s = type(ds)(n_frames=2, H=64, W=64)
        tr_s = CurvedTrainer(ds_s, mesh_field.make_state(MeshProjector(
            make_icosphere(2, radius=0.5), device=dev_i)), ccfg_s,
            RenderConfig(**SMALL_CURVED_RENDER), tcfg, seed=0, device=dev_i)
        if name == "cpu":
            seeded_curved(tr_s, TABLE_SCALE)
            tr_s.initialize_states(1)
            ref_state = tr_s.state
        else:
            tr_s.state.params = tree_to(ref_state.params, dev_i)
            tr_s.state.ema_params = tr_s.state.params
            tr_s.state.occ = type(ref_state.occ)(
                *(t.to(dev_i) for t in ref_state.occ))
        pose = orbit_pose(1.2, 0.7, 2.0)
        small[name] = [tr_s.render_frame(pose, parity=par)
                       for par in (False, True)]
    for i, name in enumerate(("live", "pool")):
        a = small["cuda"][i]["image"].cpu().numpy()
        b = small["cpu"][i]["image"].cpu().numpy()
        live_a = small["cuda"][i]["weights_sum"].cpu().numpy() > 0
        live_b = small["cpu"][i]["weights_sum"].cpu().numpy() > 0
        p_s, e_s = psnr(a, b), float(np.abs(a - b).max())
        mism = float(np.mean(live_a != live_b))
        print(f"curved parity: {name} 64x64 frame card vs CPU: PSNR "
              f"{p_s:.2f} dB, max abs {e_s:.3g}, live mismatch {mism:.4f} "
              f"({int(live_b.sum())} live on CPU) ({card})")
        check(live_b.any() and b[live_b].std() > 1e-2,
              f"the small {name} frame has no structure")
        check(p_s >= FRAME_PSNR_MIN and e_s <= FRAME_MAX_ABS
              and mism <= FRAME_LIVE_MISMATCH,
              f"curved {name} card vs CPU: PSNR {p_s} dB, max abs {e_s}, "
              f"live mismatch {mism}")
    torch.backends.cuda.matmul.allow_tf32 = True
    return {"launches": live["launches"], "max_abs_err": err}


def op_shares(fn, top: int = 8):
    """(op, share of the device time) of the ``top`` aten ops by self
    device time over one call of fn (torch.profiler's key_averages)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()]
    rows = [(k, t) for k, t in rows if t > 0 and k.startswith("aten::")]
    total = sum(t for _, t in rows) or 1.0
    return [(k[6:], t / total) for k, t in sorted(rows, key=lambda r: -r[1])
            ][:top]


def white_gt(ds, pose):
    """The analytic ground truth of a pose on a white background."""
    from nerf_texture_tpu_torch.data.synthetic import render_gt_sphere

    gt = render_gt_sphere(pose, ds.intrinsics, ds.H, ds.W, ds.sphere_radius)
    a = gt[..., 3:].astype(np.float32) / 255.0
    return gt[..., :3].astype(np.float32) / 255.0 * a + (1.0 - a)


def timed_frames(render, poses, kernel=None):
    """(ms per frame, outputs, launches of ``kernel`` (proxy_select_cdf
    by default), chunks) over the poses; the kernel's count is set to 0
    first and read after."""
    from nerf_texture_tpu_torch.ops.proxy_select import proxy_select_cdf

    kernel = kernel or proxy_select_cdf
    kernel.launches = 0
    walls, outs = [], []
    for pose in poses:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(render(pose))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls, outs, kernel.launches, sum(o["chunks"] for o in outs)


def curved_train_phase(dev, card: str, ds, timing: dict) -> dict:
    """Phase 10: curved training at the width of bench.py's curved arm
    (its schedule: initialize_states(1), train(17), a timed train(48),
    the rest to 700 steps), then the trained field at the novel pose: the
    live, pool and EMA parity frames, the bake, the baked frames at cap 5
    K 16 and cap 6 K 20, each PSNR gated against the JAX package's cell.
    Returns the selection launches of the trained live and baked frames
    and the selection error at the baked shapes, and the trainer."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.ops.proxy_select import (
        proxy_select_cdf, proxy_select_cdf_reference)
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)
    from nerf_texture_tpu_torch.utils.metrics import psnr as psnr_of

    # training multiplies f32 gradients, and the curved shading f32
    # operands, which TF32 would round: full f32
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- the selection kernel at the baked render's shapes -----------------
    err = 0.0
    for seed, (N, K, cap) in enumerate(BAKED_SHAPES):
        args = selection_inputs(N, K, 50 + seed, dev)
        got = proxy_select_cdf(*args, cap=cap, w_eps=1e-4)
        ref = proxy_select_cdf_reference(*args, cap=cap, w_eps=1e-4)
        torch.cuda.synchronize()
        e = check_selection("proxy_select_cdf", got, ref, N, K, cap,
                            zero_unfilled=False, args=args)
        err = max(err, e)
        plain = cuda_ms(lambda: proxy_select_cdf_reference(
            *args, cap=cap, w_eps=1e-4))
        timing[(N, K, cap)] = plain
        print(f"kernel: proxy_select_cdf [{N}, {K}] cap {cap}: max abs err "
              f"{e:.3g}; plain version {plain * 1e3:.2f} us a call ({card})")

    # -- training -----------------------------------------------------------
    ccfg = CurvedFieldConfig(field=MeshFieldConfig(), light_model="SH")
    rcfg = RenderConfig(**CURVED_RENDER)
    tcfg = CurvedTrainConfig(**CURVED_TRAIN)
    tr = CurvedTrainer(ds, mesh_field.make_state(MeshProjector(
        make_icosphere(4, radius=0.5), device=dev)), ccfg, rcfg, tcfg,
        seed=7, device=dev)
    tr._get_near_cells()                     # host set-up, timed in phase 9
    tr._anchor_table()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.initialize_states(1)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    first = tr.train(CURVED_WARM_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = tr.train(CURVED_TIMED_STEPS)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    # one step without a refresh (the count is not a multiple of 16)
    check(tr.state.step % tcfg.grid_update_interval != 0,
          "the profiled step would refresh the grid")
    n_k, k_ms = profile_frame(lambda: tr.train(1))
    shares = op_shares(lambda: tr.train(1))
    rest = tr.train(CURVED_TRAIN_STEPS - tr.state.step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = np.asarray(first["losses"] + timed["losses"] + rest["losses"])
    its = CURVED_TIMED_STEPS / timed_s
    occupied = int(tr.state.occ.occ.sum())
    print(f"curved train: loss step 1 {first['losses'][0]:.5f}, step "
          f"{CURVED_WARM_STEPS} {first['losses'][-1]:.5f}, step "
          f"{tr.state.step} {rest['loss']:.5f}; {CURVED_TIMED_STEPS} steps "
          f"(3 refresh cycles) in {timed_s:.2f} s = {its:.2f} it/s; one "
          f"profiled step: {n_k} CUDA kernels, {k_ms:.2f} ms of kernel time "
          f"({card})")
    print(f"curved train: by op (self device time of one step): "
          f"{', '.join(f'{k} {100 * s:.1f}%' for k, s in shares)} ({card})")
    print(f"curved train: a grid refresh {refresh_s:.3f} s; "
          f"{int(tr.state.occ.iter_density)} refreshes, {occupied} of "
          f"{rcfg.grid_size ** 3} cells occupied; peak memory {peak:.1f} "
          f"MiB ({card})")
    check(bool(np.isfinite(losses).all()), "non-finite curved training loss")
    check(tr.state.step == CURVED_TRAIN_STEPS, f"{tr.state.step} steps")
    check(0 < occupied < rcfg.grid_size ** 3, f"occupied cells {occupied}")

    # -- the trained field at the novel pose --------------------------------
    npose = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    gt = white_gt(ds, npose)
    timed_poses = [ds.poses[1 + i] for i in range(3)]
    tr.render_frame(ds.poses[0], use_ema=False)               # warm-up
    walls, outs, live_launches, live_chunks = timed_frames(
        lambda p: tr.render_frame(p, use_ema=False), [npose] + timed_poses)
    check(live_launches > 0 and live_launches == live_chunks,
          f"trained live: {live_launches} kernel launches for {live_chunks} "
          f"chunks")
    for o in outs:
        frame_checks(o, ds.H, ds.W, "trained live")
    live_img = outs[0]["image"]
    psnrs = {"live": psnr_of(live_img, gt)}
    check_twin("curved trained live", live_img.cpu().numpy(),
               tr.render_frame(npose, use_ema=False,
                               plain_select=True)["image"].cpu().numpy(),
               card)
    psnrs["pool"] = psnr_of(tr.render_frame(npose, use_ema=False,
                                            parity=True)["image"], gt)
    psnrs["ema_parity"] = psnr_of(tr.render_frame(npose, use_ema=True,
                                                  parity=True)["image"], gt)
    live_ms = walls[1:]
    live_prof = profile_frame(lambda: tr.render_frame(timed_poses[0],
                                                      use_ema=False))

    # -- the bake and the baked frames --------------------------------------
    tr.rcfg = dataclasses.replace(rcfg, **CURVED_BAKED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bake, _ = tr.bake_atlas()
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    tiles = int(bake.tile_of_cell.max()) + 1
    tr.render_frame(ds.poses[0], use_ema=False, baked=True)   # warm-up
    walls, outs, baked_launches, baked_chunks = timed_frames(
        lambda p: tr.render_frame(p, use_ema=False, baked=True),
        [npose] + timed_poses)
    check(baked_launches > 0 and baked_launches == baked_chunks,
          f"baked: {baked_launches} kernel launches for {baked_chunks} "
          f"chunks")
    for o in outs:
        frame_checks(o, ds.H, ds.W, "baked")
    psnrs["baked"] = psnr_of(outs[0]["image"], gt)
    check_twin("curved baked", outs[0]["image"].cpu().numpy(),
               tr.render_frame(npose, use_ema=False, baked=True,
                               plain_select=True)["image"].cpu().numpy(),
               card)
    baked_ms = walls[1:]
    baked_prof = profile_frame(lambda: tr.render_frame(
        timed_poses[0], use_ema=False, baked=True))
    # the discriminator of the baked frame's drift: the live field at the
    # baked arm's settings (K 16, cap 5, block 8, tau_cull 0.1)
    psnrs["live_k16"] = psnr_of(tr.render_frame(npose, use_ema=False)[
        "image"], gt)
    tr.rcfg = dataclasses.replace(tr.rcfg, **CURVED_BAKED_CAP6)
    proxy_select_cdf.launches = 0
    out6 = tr.render_frame(npose, use_ema=False, baked=True)
    check(proxy_select_cdf.launches == out6["chunks"],
          "baked cap 6: launches != chunks")
    baked_launches += proxy_select_cdf.launches
    psnrs["baked_cap6"] = psnr_of(out6["image"], gt)
    print(f"curved bake: {bake_s:.2f} s, {tiles} tiles of {bake.T}x{bake.T} "
          f"texels, atlas {bake.atlas.shape[0]} x {bake.atlas.shape[1]} "
          f"bf16 ({card})")
    for name, ms, chunks, (n_k, k_ms) in (
            ("live", live_ms, live_chunks, live_prof),
            ("baked", baked_ms, baked_chunks, baked_prof)):
        print(f"curved trained {name} {ds.H}x{ds.W}: "
              f"{', '.join(f'{w:.2f}' for w in ms)} ms/frame (median "
              f"{float(np.median(ms)):.2f}) over {len(ms)} poses; "
              f"{chunks} chunks and as many launches over 4 frames; one "
              f"profiled frame: {n_k} CUDA kernels, {k_ms:.2f} ms of kernel "
              f"time ({card})")
    for name in CURVED_PSNR_MIN:
        print(f"curved quality: {name} {psnrs[name]:.2f} dB at the novel pose "
              f"(JAX package {JAX_CURVED_PSNR[name]}, gap "
              f"{psnrs[name] - JAX_CURVED_PSNR[name]:+.2f}; gate "
              f">= {CURVED_PSNR_MIN[name]}) ({card})")
    for name, floor in CURVED_PSNR_MIN.items():
        check(psnrs[name] >= floor, f"curved {name} PSNR {psnrs[name]:.2f} "
              f"< {floor}")
    print(f"curved quality: at the baked arm's settings (K 16, cap 5): live "
          f"{psnrs['live_k16']:.2f} dB, baked {psnrs['baked']:.2f} dB; pool - "
          f"live K16 {psnrs['pool'] - psnrs['live_k16']:+.2f} dB, pool - "
          f"baked {psnrs['pool'] - psnrs['baked']:+.2f} dB ({card})")
    check(psnrs["ema_parity"] >= 24.0, "the EMA parity gate is below 24 dB")
    del bake
    tr.rcfg = rcfg
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = True
    return {"live": live_launches, "baked": baked_launches,
            "max_abs_err": err, "psnr_live": psnrs["live"]}, tr


def quilt(field_path: str, tex_path: str, size: int) -> tuple:
    """Quilt a field npz's patches (features || phi || local TBN) into a
    size^2 canvas and write the texture npz, as the reference's
    patch_matching_and_quilting does; returns the canvas's shape."""
    from nerf_texture_tpu_torch.synthesis.quilting import (
        QuiltingConfig, QuiltingSynthesizer)

    data = np.load(field_path, allow_pickle=True)
    ps = data["patches"].shape[1]
    patches = np.concatenate(
        [data["patches"], data["patch_phi_embed"],
         data["patch_local_tbn"].reshape(*data["patch_local_tbn"].shape[:3],
                                         9)], -1)
    syn = QuiltingSynthesizer(
        patches, QuiltingConfig(output_size=(size, size), seed=0),
        match_dim=data["patches"].shape[-1],
        sample_tbn=data["patch_sample_tbn"],
        picked_vertices=data["picked_vertices"],
        patch_length=float(data["grid_gap"]) * ps)
    syn.synthesize()
    tex = syn.export(grid_gap=float(data["grid_gap"]),
                     phi_embed_dim=data["patch_phi_embed"].shape[-1])
    np.savez(tex_path, **{k: v for k, v in tex.items() if v is not None})
    return tex["features"].shape


def facing_pose(normal, radius: float, tilt: float = 0.0):
    """An orbit pose (looking at the origin) from the direction of
    ``normal``, tilted by ``tilt`` in both angles."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose

    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    return orbit_pose(float(np.arccos(np.clip(n[1], -1, 1))) + tilt,
                      float(np.arctan2(n[0], n[2])) + tilt, radius)


def canvas_share(pose, intrinsics, H: int, W: int, bounds) -> float:
    """Share of the frame's rays that hit the z = 0 canvas of half-extents
    ``bounds``."""
    from nerf_texture_tpu_torch.data.rays import get_rays

    r = get_rays(torch.as_tensor(pose), torch.as_tensor(intrinsics), H, W)
    o, d = r["rays_o"], r["rays_d"]
    t = -o[:, 2] / torch.where(d[:, 2].abs() > 1e-9, d[:, 2], 1e-9)
    p = o + t[:, None] * d
    hit = (t > 0) & (p[:, 0].abs() <= float(bounds[0])) \
        & (p[:, 1].abs() <= float(bounds[1]))
    return float(hit.float().mean())


def import_frames(tr, name, poses, kernel, card):
    """800x800 frames of an imported texture (``name`` labels its lines):
    a warm-up, then the timed poses[1:] with ``kernel``'s launches ==
    chunks, frame checks, a frame re-rendered with the plain selection
    held to its kernel frame, one profiled frame; returns (launches, the
    first timed frame, its profiled kernel ms)."""
    H, W = tr.H, tr.W
    tr.render_frame(poses[0], use_ema=False)                  # warm-up
    walls, outs, launches, chunks = timed_frames(
        lambda p: tr.render_frame(p, use_ema=False), poses[1:], kernel)
    check(launches > 0 and launches == chunks,
          f"{name}: {launches} kernel launches for {chunks} chunks")
    for o in outs:
        frame_checks(o, H, W, name)
    check_twin(name, outs[0]["image"].cpu().numpy(),
               tr.render_frame(poses[1], use_ema=False, plain_select=True)[
                   "image"].cpu().numpy(), card)
    n_k, k_ms = profile_frame(lambda: tr.render_frame(poses[1],
                                                      use_ema=False))
    print(f"{name} {H}x{W}: "
          f"{', '.join(f'{w:.2f}' for w in walls)} ms/frame (median "
          f"{float(np.median(walls)):.2f}) over {len(walls)} poses; live rays "
          f"{[o['live'] for o in outs]}; {kernel.__name__} launches "
          f"{launches} for {chunks} chunks; one profiled frame: {n_k} CUDA "
          f"kernels, {k_ms:.2f} ms of kernel time ({card})")
    return launches, outs[0], k_ms


def texture_phase(dev, card: str, ds, tr) -> dict:
    """Phase 11: the flat texture pipeline on the trained curved field
    ``tr`` (bench width, its RenderConfig); returns the launches of each
    import path's frames and the grid-sample / kNN shares."""
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import weighted_project
    from nerf_texture_tpu_torch.ops.proxy_select import (proxy_select,
                                                         proxy_select_cdf)
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.synthesis.patches import PatchSampleConfig
    from nerf_texture_tpu_torch.train import field_io
    from nerf_texture_tpu_torch.utils.grid_sample import grid_sample_2d

    torch.backends.cuda.matmul.allow_tf32 = False      # curved shading
    os.makedirs(TEXTURE_DIR, exist_ok=True)
    field_path = os.path.join(TEXTURE_DIR, "field.npz")
    tex_path = os.path.join(TEXTURE_DIR, "texture.npz")
    rcfg = RenderConfig(**CURVED_RENDER)
    tr.rcfg = rcfg
    mesh = make_icosphere(4, radius=0.5)

    # -- export, quilt ----------------------------------------------------
    scfg = PatchSampleConfig(max_patch_num=TEXTURE_PATCHES)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = field_io.save_field(tr, field_path, mesh=mesh, scfg=scfg,
                              stats=stats)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    kept = exp["patches"].shape[0]
    print(f"texture: export {export_s:.2f} s: {stats['candidates']} candidate "
          f"centres, {kept} patches kept of {scfg.patch_size}^2 texels "
          f"(grid gap {exp['grid_gap']:.3g}), {stats['rays']} texel rays cast "
          f"= {stats['rays'] / export_s:.4g} rays/s (with the projection and "
          f"encode of the kept texels) ({card})")
    # the y >= 0 veto drops about half of the 2x oversampled candidates,
    # as in the JAX package: the budget is a ceiling
    check(TEXTURE_PATCHES // 2 <= kept <= TEXTURE_PATCHES,
          f"{kept} patches kept")
    check(all(np.isfinite(exp[k]).all() for k in ("patches",
                                                  "patch_phi_embed",
                                                  "patch_local_tbn")),
          "non-finite exported channels")
    check(float(np.abs(exp["patches"]).max()) > 0, "the exported features "
          "are all zero")
    t0 = time.perf_counter()
    shape = quilt(field_path, tex_path, TEXTURE_SIZE)
    quilt_s = time.perf_counter() - t0
    print(f"texture: quilting {quilt_s:.2f} s (host), canvas {shape[0]}x"
          f"{shape[1]} x {shape[2]} feature channels ({card})")
    check(shape[0] >= TEXTURE_SIZE and shape[1] >= TEXTURE_SIZE,
          f"canvas {shape}")
    del exp

    # -- the quilted texture imported: mode 'field' ---------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    field_io.load_field(tr, tex_path)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    occupied = int(tr.state.occ.occ.sum())
    near = tr._get_near_cells().shape[0]
    print(f"texture: load_field + initialize_states (50 refreshes over "
          f"{near} slab cells) {init_s:.2f} s; {occupied} cells occupied "
          f"({card})")
    check(tr.mode == "field" and occupied > 0, "the field import is empty")
    bounds = tr.field_state.imported.bounds.cpu().numpy()
    down = [orbit_pose_down(0.08 * i) for i in range(4)]
    share = canvas_share(down[1], ds.intrinsics, ds.H, ds.W, bounds)
    print(f"texture: canvas half-extents {bounds[0]:.3f} x {bounds[1]:.3f}; "
          f"it covers {100 * share:.1f}% of the first timed frame ({card})")
    check(share >= 0.25, f"the canvas covers {share} of the frame")
    launches = {}
    launches["texture_field"], out_f, field_ms = import_frames(
        tr, "texture field (CDF)", down, proxy_select_cdf, card)
    # the grid samples' share of the frame: 4 a chunk on its survivors
    pts = torch.rand((rcfg.ray_chunk * rcfg.infer_color_cap, 2),
                     device=dev) * 2 - 1
    imp = tr.field_state.imported
    ids = imp.sample_tbn_ids_2d[..., None].float()
    n_gs, gs_ms = profile_frame(lambda: (
        grid_sample_2d(imp.features_2d, pts),
        grid_sample_2d(imp.phi_embed_2d, pts),
        grid_sample_2d(imp.local_tbn_2d, pts, mode="nearest"),
        grid_sample_2d(ids, pts, mode="nearest")))
    n_chunks = -(-out_f["live"] // rcfg.ray_chunk)
    print(f"texture: grid_sample_2d, the 4 canvas reads of a chunk's "
          f"{pts.shape[0]} survivors: {n_gs} kernels, {gs_ms:.3f} ms of "
          f"kernel time, x {n_chunks} chunks = "
          f"{100 * gs_ms * n_chunks / field_ms:.1f}% of the field frame's "
          f"kernel time ({card})")
    tr.rcfg = dataclasses.replace(rcfg, **TWO_ROUND)
    proxy_select_cdf.launches = 0
    launches["texture_two_round"], _, _ = import_frames(
        tr, "texture field two-round (top-k)", down, proxy_select, card)
    check(proxy_select_cdf.launches == 0, "the two-round frames launched "
          "proxy_select_cdf")
    tr.rcfg = rcfg

    # -- one patch imported: mode 'patch' -------------------------------------
    data = np.load(field_path, allow_pickle=True)
    normal = data["patch_norms"][0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    field_io.load_patch(tr, field_path, patch_id=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    occupied = int(tr.state.occ.occ.sum())
    print(f"texture: load_patch + initialize_states (50 refreshes over "
          f"{tr._get_near_cells().shape[0]} cells) {init_s:.2f} s; "
          f"{occupied} cells occupied ({card})")
    # from 1.4 along the patch normal: the sphere's decayed shell does
    # not fill the frame
    at_patch = [facing_pose(normal, 1.4, 0.03 * i) for i in range(4)]
    launches["texture_patch"], out_p, patch_ms = import_frames(
        tr, "texture patch (CDF)", at_patch, proxy_select_cdf, card)
    x = torch.rand((rcfg.ray_chunk * rcfg.infer_color_cap, 3), device=dev) \
        * 0.1 - 0.05 + torch.as_tensor(data["picked_vertices"][0],
                                       dtype=torch.float32, device=dev)
    n_knn, knn_ms = profile_frame(lambda: weighted_project(
        tr.field_state.projector_imported, x, k=8, direct_above_check=True,
        direct_above_threshold=1.0))
    n_chunks = -(-out_p["live"] // rcfg.ray_chunk)
    print(f"texture: weighted_project (kNN over the patch points) of a "
          f"chunk's {x.shape[0]} survivors: {n_knn} kernels, {knn_ms:.3f} ms "
          f"of kernel time, x {n_chunks} chunks = "
          f"{100 * knn_ms * n_chunks / patch_ms:.1f}% of the patch frame's "
          f"kernel time ({card})")
    del data

    # -- the narrow config on the card vs the CPU port, on the CPU's files ---
    small, exports, cpu_occ = {}, {}, []
    tex_small = os.path.join(TEXTURE_DIR, "texture_small.npz")
    for name, dev_i in (("cpu", torch.device("cpu")), ("cuda", dev)):
        tr_s = narrow_curved(ds, dev_i, ref if name == "cuda" else None)
        ref = tr_s.state
        path = os.path.join(TEXTURE_DIR, f"field_small_{name}.npz")
        exports[name] = field_io.save_field(
            tr_s, path, mesh=make_icosphere(2, radius=0.5),
            scfg=PatchSampleConfig(**SMALL_TEXTURE))
        if name == "cpu":
            quilt(path, tex_small, SMALL_TEXTURE_SIZE)
            field_small = path
        frames = []
        for load in (lambda: field_io.load_field(tr_s, tex_small),
                     lambda: field_io.load_patch(tr_s, field_small, 0)):
            load()
            if name == "cpu":
                cpu_occ.append(tr_s.state.occ)
            else:               # the CPU's grid: the frames compare alone
                occ = cpu_occ[len(frames)]
                tr_s.state.occ = type(occ)(*(t.to(dev_i) for t in occ))
            pose = (orbit_pose_down(0.3) if tr_s.mode == "field" else
                    facing_pose(exports["cpu"]["patch_norms"][0], 1.4))
            frames.append(tr_s.render_frame(pose, use_ema=False))
        small[name] = frames
    a, b = exports["cuda"], exports["cpu"]
    check(np.array_equal(a["picked_vertices"], b["picked_vertices"]),
          "the card kept other patches than the CPU")
    exp_err = max(float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(),
                                                        1e-12))
                  for k in ("patches", "patch_phi_embed"))
    print(f"texture parity: the narrow export on the card vs the CPU: "
          f"{len(a['patches'])} patches, the same centres, features within "
          f"{exp_err:.3g} of their largest entry ({card})")
    check(exp_err <= 1e-4, f"exported features differ by {exp_err}")
    for i, name in enumerate(("field", "patch")):
        fa, fb = small["cuda"][i], small["cpu"][i]
        ia, ib = fa["image"].cpu().numpy(), fb["image"].cpu().numpy()
        la = fa["weights_sum"].cpu().numpy() > 0
        lb = fb["weights_sum"].cpu().numpy() > 0
        p_s, e_s = psnr(ia, ib), float(np.abs(ia - ib).max())
        mism = float(np.mean(la != lb))
        print(f"texture parity: {name} 64x64 frame card vs CPU on the same "
              f"file: PSNR {p_s:.2f} dB, max abs {e_s:.3g}, live mismatch "
              f"{mism:.4f} ({int(lb.sum())} live on CPU) ({card})")
        check(lb.any() and ib[lb].std() > 1e-3,
              f"the small {name} frame has no structure")
        check(p_s >= FRAME_PSNR_MIN and e_s <= FRAME_MAX_ABS
              and mism <= FRAME_LIVE_MISMATCH,
              f"texture {name} card vs CPU: PSNR {p_s} dB, max abs {e_s}, "
              f"live mismatch {mism}")
    torch.backends.cuda.matmul.allow_tf32 = True
    return launches


def surfaces_phase(dev, card: str, ds, tr, live_psnr: float) -> dict:
    """Phase 12: phase 11's patches synthesised onto another mesh and the
    imports onto it, on phase 10's trained field ``tr`` (bench width, its
    RenderConfig): the curved synthesis (the CLI's function), then
    ``load_field`` + ``load_shape``, ``load_unhash`` and ``unhash``, each
    with 800x800 frames through proxy_select_cdf; then the narrow config
    on the card and on the CPU port on one CPU-written curved_mesh.npz.
    Returns the selection launches of each import's frames."""
    import resource

    import texture_synthesis_on_curved_surface_torch as syn_cli
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.geometry import projector as proj
    from nerf_texture_tpu_torch.geometry.mesh import save_obj
    from nerf_texture_tpu_torch.ops.proxy_select import proxy_select_cdf
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train import field_io
    from nerf_texture_tpu_torch.utils.metrics import psnr as psnr_of

    torch.backends.cuda.matmul.allow_tf32 = False      # curved shading
    os.makedirs(SURFACE_DIR, exist_ok=True)
    rcfg = RenderConfig(**CURVED_RENDER)
    tr.rcfg = rcfg
    fcfg = tr.ccfg.field
    field_path = os.path.join(TEXTURE_DIR, "field.npz")
    tex_path = os.path.join(TEXTURE_DIR, "texture.npz")
    target_path = os.path.join(SURFACE_DIR, "target.obj")
    curved_path = os.path.join(SURFACE_DIR, "curved_mesh.npz")

    # -- the target mesh and the curved synthesis ---------------------------
    t0 = time.perf_counter()
    target = surface_target()
    save_obj(target_path, target)
    print(f"surfaces: target mesh, a rounded box {SURFACE_BOX}: "
          f"{len(target.vertices)} vertices, {len(target.faces)} faces in "
          f"{time.perf_counter() - t0:.2f} s")
    st = {}
    t0 = time.perf_counter()
    syn_cli.synthesise(field_path, target_path, grid_gap=SURFACE_GAP,
                       resolution=SURFACE_RES, device=dev,
                       max_iters=SURFACE_ITERS, progress=False,
                       out=curved_path, stats=st)
    syn_s = time.perf_counter() - t0
    it = max(st["iters"], 1)
    host_s = st["loop_s"] - st["device_s"]
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"surfaces: curved synthesis (grid gap {SURFACE_GAP:g}, at most "
          f"{SURFACE_ITERS} iterations) {syn_s:.2f} s: set-up "
          f"{st['setup_s']:.2f} s (patch library, projector, uv2vert, range "
          f"votes, matcher); {st['iters']} iterations in {st['loop_s']:.2f} "
          f"s = {st['loop_s'] / it:.3f} s an iteration "
          f"({st['device_s'] / it:.3f} s device queries: ray cast, uvh, "
          f"canvas reads; {host_s / it:.3f} s host); UV coverage "
          f"{100 * st['done']:.1f}% of the {st['texels']} texels on the "
          f"surface ({100 * st['texels'] / SURFACE_RES ** 2:.1f}% of the "
          f"{SURFACE_RES}^2 map); process peak RSS {rss:.2f} GiB ({card})")
    feats = np.load(curved_path)["features"]
    check(st["iters"] > 0 and st["done"] >= SURFACE_MIN_DONE
          and bool(np.isfinite(feats).all()),
          f"curved synthesis: {st['iters']} iterations, {st['done']} of the "
          f"texels set")
    del feats

    # -- the imports: load_shape, load_unhash, unhash ------------------------
    def near_surface(n: int = rcfg.ray_chunk * rcfg.infer_color_cap):
        """n points within 0.1 of the imported mesh's vertices."""
        pa = tr.field_state.projector_imported
        g = torch.Generator(device=dev).manual_seed(0)
        i = torch.randint(0, pa.vertices.shape[0], (n,), generator=g,
                          device=dev)
        h = torch.rand((n, 1), generator=g, device=dev) * 0.2 - 0.1
        return pa.vertices[i] + pa.vertex_normals[i] * h

    def shape_chain(x):
        return proj.uvh(tr.field_state.projector_imported, x,
                        k=fcfg.k_for_uv, h_threshold=fcfg.h_threshold,
                        sdf_scale=1.0, sdf_offset=0.0)

    def unhash_chain(x):
        n, _, _, _ = proj.knn_normal(tr.field_state.projector, x, k=fcfg.k)
        return proj.barycentric_mapping(tr.field_state.projector_imported, x,
                                        n, h_threshold=fcfg.h_threshold)

    t0 = time.perf_counter()
    field_io.load_field(tr, tex_path)   # mode 'shape' reads its phi / TBN
    print(f"surfaces: load_field (the phi and TBN canvases of mode 'shape') "
          f"{time.perf_counter() - t0:.2f} s")
    npose = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    novel = [orbit_pose(1.25 + 0.1 * i, 2 * np.pi * (i + 0.5) / 8, 2.0)
             for i in range(4)]
    launches = {}
    for key, name, load, poses, chain, what in (
            ("surface_shape", "load_shape",
             lambda: field_io.load_shape(tr, target), novel, shape_chain,
             "uvh"),
            ("surface_curved_synthesis", "load_unhash",
             lambda: field_io.load_unhash(tr, curved_path), novel,
             shape_chain, "uvh"),
            ("surface_unhash", "unhash",
             lambda: field_io.unhash(tr, min_vertices=UNHASH_MIN_VERTICES),
             [ds.poses[0], npose, ds.poses[1], ds.poses[2]], unhash_chain,
             "knn_normal + barycentric_mapping")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mp = load()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        occupied = int(tr.state.occ.occ.sum())
        print(f"surfaces: {name} + initialize_states (50 refreshes over "
              f"{tr._get_near_cells().shape[0]} cells) {init_s:.2f} s; mesh "
              f"{len(mp.mesh.vertices)} vertices "
              f"({mp.arrays.vertices.shape[0]} after the UV atlas); mode "
              f"{tr.mode!r}; {occupied} cells occupied ({card})")
        check(occupied > 0, f"the {name} import is empty")
        launches[key], out, k_ms = import_frames(
            tr, f"surfaces {name} (CDF)", poses, proxy_select_cdf, card)
        x = near_surface()
        n_c, c_ms = profile_frame(lambda: chain(x))
        n_chunks = -(-out["live"] // rcfg.ray_chunk)
        print(f"surfaces: {name}: {what} of a chunk's {x.shape[0]} "
              f"survivors: {n_c} kernels, {c_ms:.3f} ms of kernel time, x "
              f"{n_chunks} chunks = {100 * c_ms * n_chunks / k_ms:.1f}% of "
              f"the frame's kernel time ({card})")
    check(len(mp.mesh.vertices) >= UNHASH_MIN_VERTICES,
          f"unhash mesh of {len(mp.mesh.vertices)} vertices")
    p_u = psnr_of(out["image"], white_gt(ds, npose))
    print(f"surfaces: the unhash frame at the novel pose {p_u:.2f} dB, the "
          f"trained live frame {live_psnr:.2f} dB (not gated: no JAX cell; "
          f"the features follow the subdivided mesh's vertex order, which "
          f"the projector's UV atlas renumbers, as in the JAX package) "
          f"({card})")
    photo = os.path.join(SURFACE_DIR, "unhash_novel.png")
    img = field_io.take_photo(tr, npose, path=photo)
    check(img.shape == (ds.H, ds.W, 3) and os.path.getsize(photo) > 0,
          f"take_photo wrote {photo} of {img.shape}")
    print(f"surfaces: take_photo {photo}: {os.path.getsize(photo)} bytes")

    # -- the narrow config on the card vs the CPU port, on one file ----------
    cpu = torch.device("cpu")
    small_target = os.path.join(SURFACE_DIR, "target_small.obj")
    curved_small = os.path.join(SURFACE_DIR, "curved_mesh_small.npz")
    save_obj(small_target, surface_target(SMALL_SURFACE["min_vertices"]))
    st = {}
    t0 = time.perf_counter()
    syn_cli.synthesise(os.path.join(TEXTURE_DIR, "field_small_cpu.npz"),
                       small_target, grid_gap=SMALL_SURFACE["grid_gap"],
                       resolution=SMALL_SURFACE["resolution"], device=cpu,
                       max_iters=SMALL_SURFACE["max_iters"], progress=False,
                       out=curved_small, stats=st)
    print(f"surfaces parity: the CPU's narrow synthesis "
          f"{time.perf_counter() - t0:.2f} s, {st['iters']} iterations, "
          f"{100 * st['done']:.1f}% of {st['texels']} texels")
    pose = orbit_pose(1.2, 0.7, 2.0)
    small, cpu_occ = {}, []
    for name, dev_i in (("cpu", cpu), ("cuda", dev)):
        tr_s = narrow_curved(ds, dev_i, ref if name == "cuda" else None)
        ref = tr_s.state
        field_io.load_field(tr_s, os.path.join(TEXTURE_DIR,
                                               "texture_small.npz"))
        frames = []
        for load in (lambda: field_io.load_unhash(tr_s, curved_small),
                     lambda: field_io.unhash(
                         tr_s, min_vertices=SMALL_UNHASH_VERTICES)):
            load()
            if name == "cpu":
                cpu_occ.append(tr_s.state.occ)
            else:               # the CPU's grid: the frames compare alone
                occ = cpu_occ[len(frames)]
                tr_s.state.occ = type(occ)(*(t.to(dev_i) for t in occ))
            frames.append(tr_s.render_frame(pose, use_ema=False))
        small[name] = frames
    for i, name in enumerate(("load_unhash", "unhash")):
        fa, fb = small["cuda"][i], small["cpu"][i]
        ia, ib = fa["image"].cpu().numpy(), fb["image"].cpu().numpy()
        la = fa["weights_sum"].cpu().numpy() > 0
        lb = fb["weights_sum"].cpu().numpy() > 0
        p_s, e_s = psnr(ia, ib), float(np.abs(ia - ib).max())
        mism = float(np.mean(la != lb))
        print(f"surfaces parity: {name} 64x64 frame card vs CPU on the same "
              f"file: PSNR {p_s:.2f} dB, max abs {e_s:.3g}, live mismatch "
              f"{mism:.4f} ({int(lb.sum())} live on CPU) ({card})")
        check(lb.any() and ib[lb].std() > 1e-3,
              f"the small {name} frame has no structure")
        check(p_s >= FRAME_PSNR_MIN and e_s <= FRAME_MAX_ABS
              and mism <= FRAME_LIVE_MISMATCH,
              f"surfaces {name} card vs CPU: PSNR {p_s} dB, max abs {e_s}, "
              f"live mismatch {mism}")
    torch.backends.cuda.matmul.allow_tf32 = True
    return launches


def narrow_curved(ds, dev_i, ref=None):
    """The narrow curved config of the card-vs-CPU checks (SMALL_FIELD over
    make_icosphere(2, 0.5), 64x64 frames) on ``dev_i``: seeded and
    refreshed once, or with the params and grid of ``ref`` (a trainer
    state of the same config)."""
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)

    tr_s = CurvedTrainer(type(ds)(n_frames=2, H=64, W=64),
                         mesh_field.make_state(MeshProjector(
                             make_icosphere(2, radius=0.5), device=dev_i)),
                         CurvedFieldConfig(field=MeshFieldConfig(
                             **SMALL_FIELD), light_model="SH"),
                         RenderConfig(**SMALL_CURVED_RENDER),
                         CurvedTrainConfig(**CURVED_TRAIN), seed=0,
                         device=dev_i)
    if ref is None:
        seeded_curved(tr_s, TABLE_SCALE)
        tr_s.initialize_states(1)
    else:
        tr_s.state.params = tree_to(ref.params, dev_i)
        tr_s.state.ema_params = tr_s.state.params
        tr_s.state.occ = type(ref.occ)(*(t.to(dev_i) for t in ref.occ))
    return tr_s


def orbit_pose_down(tilt: float):
    """An orbit pose at radius 2 on the +z axis, looking down onto the
    z = 0 canvas, tilted by ``tilt`` in both angles."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose

    return orbit_pose(np.pi / 2 - tilt, tilt, 2.0)


def ngp_mesh(trainer, mcfg, dev, card: str):
    """Phase 8's mesh export: ``field_io.save_mesh`` of the trained NGP's
    density (the params, as main_nerf.py exports them) at resolution
    NGP_MESH_RES and sigma 10.  The sigma-10 set also holds the floaters
    of regions no ray trained, which the reference's template clean-up
    removes, so the gate is that the surface holds the dataset's sphere:
    NGP_MESH_COVER of NGP_MESH_PROBES points spread over it lie within
    NGP_MESH_TOL of a vertex."""
    from scipy.spatial import cKDTree

    from nerf_texture_tpu_torch.geometry.mesh import Mesh
    from nerf_texture_tpu_torch.geometry.shape_tools import (
        keep_largest_component)
    from nerf_texture_tpu_torch.models import ngp
    from nerf_texture_tpu_torch.train import field_io

    radius = trainer.dataset.sphere_radius
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v, f = field_io.save_mesh(
        lambda x: ngp.density(trainer.state.params, x, mcfg)[0],
        os.path.join(SURFACE_DIR, "ngp_mesh.obj"), resolution=NGP_MESH_RES,
        bound=mcfg.bound, device=dev)
    mesh_s = time.perf_counter() - t0
    check(len(f) > 0, "the NGP mesh is empty")
    off = np.abs(np.linalg.norm(v, axis=-1) - radius)
    k = np.arange(NGP_MESH_PROBES) + 0.5         # a Fibonacci sphere
    z = 1.0 - 2.0 * k / NGP_MESH_PROBES
    a = np.pi * (1.0 + 5.0 ** 0.5) * k
    probes = radius * np.stack([np.sqrt(1 - z * z) * np.cos(a),
                                np.sqrt(1 - z * z) * np.sin(a), z], -1)
    cover = float(np.mean(cKDTree(v).query(probes)[0] <= NGP_MESH_TOL))
    big = keep_largest_component(Mesh(v, f))
    off_big = np.abs(np.linalg.norm(big.vertices, axis=-1) - radius)
    print(f"render: save_mesh of the trained density at {NGP_MESH_RES}^3, "
          f"sigma 10: {len(v)} vertices, {len(f)} faces in {mesh_s:.2f} s; "
          f"{100 * np.mean(off <= NGP_MESH_TOL):.1f}% of the vertices within "
          f"{NGP_MESH_TOL} of the r = {radius} sphere, mean |r - {radius}| "
          f"{off.mean():.4f}; the sphere covered at {100 * cover:.1f}% of "
          f"{NGP_MESH_PROBES} points (gate >= {100 * NGP_MESH_COVER:.0f}%); "
          f"largest component {len(big.vertices)} vertices, mean "
          f"|r - {radius}| {off_big.mean():.4f} ({card})")
    check(cover >= NGP_MESH_COVER, f"the NGP mesh covers {cover} of the "
          f"sphere within {NGP_MESH_TOL}")


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def main() -> int:
    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    # Every matmul of a render multiplies bf16-rounded operands, which
    # TF32 holds exactly, with f32 accumulation: TF32 changes no product,
    # so the tensor cores may run the MLPs (training turns it off).
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    from nerf_texture_tpu_torch import kernels
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.data.synthetic import (
        SyntheticSphereDataset, shell_occupancy, sphere_intrinsics)
    from nerf_texture_tpu_torch.models import ngp
    from nerf_texture_tpu_torch.ops.proxy_select import (
        proxy_select, proxy_select_cdf, proxy_select_cdf_reference,
        proxy_select_reference)
    from nerf_texture_tpu_torch.render.renderer import (PrepassState,
                                                        RenderConfig)
    from nerf_texture_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                      ngp_infer_params,
                                                      render_frame)
    from nerf_texture_tpu_torch.utils.metrics import psnr as psnr_of
    wall0 = time.perf_counter()

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build = kernels.build("proxy_select")
    kernels.load_library("proxy_select")
    print(f"build: proxy_select.cu {build.path.name} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {build.seconds:.2f} s)")
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        build.log)
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    if build.seconds == 0.0:
        print("  (the library was built before this run: no ptxas lines)")
    else:
        check(len(spills) >= 8, f"ptxas printed {len(spills)} spill lines "
              f"for 8 kernels")
        check(all(a == "0" and b == "0" for a, b in spills),
              f"a selection kernel spills registers: {spills}")

    # -- 3. kernel vs plain version on the card ------------------------------
    max_err = 0.0
    timing = {}
    for seed, (N, K, cap) in enumerate([(16384, 24, 4), (8192, 16, 5)]):
        args = selection_inputs(N, K, seed, dev)
        got = proxy_select_cdf(*args, cap=cap, w_eps=1e-4)
        ref = proxy_select_cdf_reference(*args, cap=cap, w_eps=1e-4)
        torch.cuda.synchronize()
        err = check_selection("proxy_select_cdf", got, ref, N, K, cap,
                              zero_unfilled=False, args=args)
        max_err = max(max_err, err)
        plain = cuda_ms(lambda: proxy_select_cdf_reference(
            *args, cap=cap, w_eps=1e-4))
        timing[(N, K, cap)] = plain
        print(f"kernel: proxy_select_cdf [{N}, {K}] cap {cap}: max abs err "
              f"{err:.3g}; plain version {plain * 1e3:.2f} us a call "
              f"({card})")

    # -- 4. port on the card vs port on the CPU ------------------------------
    mcfg_s = ngp.NGPConfig(**SMALL_NGP)
    rcfg_s = RenderConfig(**SMALL_RENDER)
    params_cpu = seeded_params(ngp, mcfg_s, torch.Generator().manual_seed(0))
    params_gpu = {k: ([{n: t.to(dev) for n, t in layer.items()}
                       for layer in v] if isinstance(v, list) else v.to(dev))
                  for k, v in params_cpu.items()}
    Hs = Ws = 64
    intr_s = sphere_intrinsics(Hs, Ws)
    pose_s = orbit_pose(1.2, 0.7, 2.0)
    frames = {}
    for name, dev_i, params in (("cpu", "cpu", params_cpu),
                                ("cuda", dev, params_gpu)):
        occ = shell_occupancy(rcfg_s.grid_size, device=dev_i)
        out = render_frame(params, occ, pose_s, intr_s, Hs, Ws, mcfg_s,
                           rcfg_s)
        frames[name] = (out["image"].cpu().numpy(),
                        out["weights_sum"].cpu().numpy() > 0)
    img_c, live_c = frames["cpu"]
    img_g, live_g = frames["cuda"]
    p_small = psnr(img_g, img_c)
    e_small = float(np.abs(img_g - img_c).max())
    mism = float(np.mean(live_c != live_g))
    print(f"parity: {Hs}x{Ws} frame card vs CPU: PSNR {p_small:.2f} dB, max "
          f"abs {e_small:.3g}, live mismatch {mism:.4f} "
          f"({int(live_c.sum())} live on CPU)")
    check(live_c.any(), "the small parity frame has no live pixel")
    check(p_small >= FRAME_PSNR_MIN and e_small <= FRAME_MAX_ABS
          and mism <= FRAME_LIVE_MISMATCH,
          f"card vs CPU frame: PSNR {p_small} dB, max abs {e_small}, live "
          f"mismatch {mism}")

    # -- 5. the slice at full width ------------------------------------------
    mcfg = ngp.NGPConfig(**BENCH_NGP)
    rcfg = RenderConfig(**BENCH_RENDER)
    H = W = 800
    intr = sphere_intrinsics(H, W)
    params = seeded_params(ngp, mcfg,
                           torch.Generator(device=dev).manual_seed(0))
    iparams = ngp_infer_params(params, mcfg)
    occ = shell_occupancy(rcfg.grid_size, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prepass = PrepassState.build(occ.occ, rcfg, density=occ.density)
    torch.cuda.synchronize()
    prepass_s = time.perf_counter() - t0
    print(f"slice: NGP {mcfg.num_levels} levels x {mcfg.level_dim}, "
          f"{mcfg.packed_spec.table_rows} table rows; grid "
          f"{rcfg.grid_size}^3; prepass state built in {prepass_s:.3f} s")

    # novel views: the 8-frame training orbit sits at phi = 2 pi k / 8,
    # these sit between its frames and off its theta curve
    poses = [orbit_pose(1.25 + 0.1 * i, 2 * np.pi * (i + 0.5) / 8, 2.0)
             for i in range(4)]

    def frame(pose, plain_select=False):
        return render_frame(iparams, None, pose, intr, H, W, mcfg, rcfg,
                            prepass=prepass, plain_select=plain_select)

    frame(poses[0])                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    proxy_select_cdf.launches = 0
    walls, outs = [], []
    for pose in poses[1:]:
        t0 = time.perf_counter()
        out = frame(pose)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    chunks_total = sum(out["chunks"] for out in outs)
    launches = proxy_select_cdf.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    check(launches > 0, "proxy_select_cdf was never launched by the slice")
    check(launches == chunks_total, f"{launches} kernel launches for "
          f"{chunks_total} chunks")
    for out in outs:
        img = out["image"]
        check(tuple(img.shape) == (H, W, 3), f"image shape {img.shape}")
        check(bool(torch.isfinite(img).all()), "non-finite pixels")
        check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
              f"image outside [0, 1]: [{float(img.min())}, "
              f"{float(img.max())}]")
        check(0 < out["live"] < H * W, f"live rays {out['live']}")
        check(float(out["weights_sum"].max()) > 0.05,
              "no pixel composites any weight")

    img_k = outs[0]["image"].cpu().numpy()
    img_p = frame(poses[1], plain_select=True)["image"].cpu().numpy()
    check_twin("slice", img_k, img_p, card)
    lives = [out["live"] for out in outs]
    print(f"slice: {H}x{W} frames: {', '.join(f'{w:.2f}' for w in walls)} "
          f"ms/frame (median {float(np.median(walls)):.2f}) over "
          f"{len(walls)} novel poses; live rays {lives}; chunks/frame "
          f"{[out['chunks'] for out in outs]}; proxy_select_cdf launches "
          f"{launches}; peak memory {peak_mb:.1f} MiB ({card})")

    slice_launches = launches
    del params, iparams, prepass, outs, occ
    torch.cuda.empty_cache()

    # -- 6. the top-k kernel vs its plain version on the card ----------------
    topk_err = 0.0
    for seed, (N, K, cap) in enumerate([(16384, 24, 8), (8192, 32, 8),
                                        (8192, 16, 4)]):
        args = selection_inputs(N, K, 10 + seed, dev)
        got = proxy_select(*args, cap=cap, w_eps=1e-4)
        ref = proxy_select_reference(*args, cap=cap, w_eps=1e-4)
        torch.cuda.synchronize()
        err = check_selection("proxy_select", got, ref, N, K, cap,
                              zero_unfilled=True)
        topk_err = max(topk_err, err)
        plain = cuda_ms(lambda: proxy_select_reference(*args, cap=cap,
                                                       w_eps=1e-4))
        timing[(N, K, cap)] = plain
        print(f"kernel: proxy_select [{N}, {K}] cap {cap}: max abs err "
              f"{err:.3g}, {int(got[2].sum())} kept of {N * cap} slots; "
              f"plain version {plain * 1e3:.2f} us a call ({card})")

    # -- 7. training at full width -------------------------------------------
    # Training multiplies f32 gradients, which TF32 would round: full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ds = SyntheticSphereDataset(n_frames=8, H=H, W=W)
    tcfg = TrainConfig(**BENCH_TRAIN)
    trainer = Trainer(ds, mcfg, rcfg, tcfg, seed=7, device=dev)
    torch.cuda.synchronize()
    print(f"train: dataset + init {time.perf_counter() - t0:.2f} s; "
          f"{ds.num_frames} frames {H}x{W}, {tcfg.num_rays} rays/step, pool "
          f"{rcfg.pool_mean_samples}/ray")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = trainer.train(WARM_STEPS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = trainer.train(TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = np.asarray(warm["losses"] + run["losses"])
    refreshes = int(trainer.state.occ.iter_density)
    occupied = int(trainer.state.occ.occ.sum())
    its = TRAIN_STEPS / train_s
    print(f"train: loss step 1 {losses[0]:.5f}, step {WARM_STEPS} "
          f"{losses[WARM_STEPS - 1]:.5f}, step {len(losses)} "
          f"{losses[-1]:.5f}; mean of first/last 50: "
          f"{losses[:50].mean():.5f} / {losses[-50:].mean():.5f}; "
          f"samples/ray {run['mean_samples']:.1f}")
    print(f"train: {WARM_STEPS} steps in {warm_s:.2f} s, {TRAIN_STEPS} steps "
          f"in {train_s:.2f} s = {its:.2f} it/s; {refreshes} grid "
          f"refreshes, {occupied} of {rcfg.grid_size ** 3} cells occupied; "
          f"peak memory {train_peak_mb:.1f} MiB ({card})")
    check(bool(np.isfinite(losses).all()), "non-finite training loss")
    check(losses[-50:].mean() < losses[:50].mean(),
          "the training loss did not fall")
    check(occupied > 0, "the occupancy grid is empty after training")
    torch.backends.cuda.matmul.allow_tf32 = True

    # -- 8. the trained field through both selections ------------------------
    rcfg_topk = dataclasses.replace(rcfg, infer_cdf=False, infer_color_cap=8)
    prepass_topk = PrepassState.build(trainer.state.occ.occ, rcfg_topk,
                                      density=trainer.state.occ.density)
    params_t = ngp_infer_params(trainer.state.params, mcfg)

    def topk_frame(pose, plain_select=False):
        return render_frame(params_t, None, pose, ds.intrinsics, H, W, mcfg,
                            rcfg_topk, prepass=prepass_topk,
                            plain_select=plain_select)

    novel = [orbit_pose(np.pi / 2 + 0.2, 0.3 + 0.1 * i, ds.radius)
             for i in range(4)]
    topk_frame(novel[0])                               # warm-up
    trainer.render_frame(novel[0], use_ema=False)
    torch.cuda.synchronize()
    proxy_select_cdf.launches = 0
    psnr_train = trainer.eval_psnr([0], use_ema=False)
    check(proxy_select_cdf.launches > 0,
          "eval_psnr never launched proxy_select_cdf")
    proxy_select_cdf.launches = 0
    proxy_select.launches = 0
    out = topk_frame(ds.poses[0])
    psnr_train_topk = psnr_of(out["image"], white_gt(ds, ds.poses[0]))
    chunks = {"cdf": 0, "topk": out["chunks"]}
    walls = {"cdf": [], "topk": []}
    outs = {}
    for name in ("cdf", "topk"):
        for pose in novel:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = (trainer.render_frame(pose, use_ema=False) if name == "cdf"
                   else topk_frame(pose))
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            chunks[name] += out["chunks"]
            outs.setdefault(name, out)
    launches = {"cdf": proxy_select_cdf.launches,
                "topk": proxy_select.launches}
    gt_novel = white_gt(ds, novel[0])
    psnr_novel = {k: psnr_of(outs[k]["image"], gt_novel) for k in outs}
    for name in ("cdf", "topk"):
        img = outs[name]["image"]
        check(bool(torch.isfinite(img).all()), f"{name}: non-finite pixels")
        check(launches[name] > 0, f"{name}: its kernel was never launched")
        check(launches[name] == chunks[name],
              f"{name}: {launches[name]} kernel launches for "
              f"{chunks[name]} chunks")
    img_k = outs["topk"]["image"].cpu().numpy()
    img_p = topk_frame(novel[0], plain_select=True)["image"].cpu().numpy()
    check_twin("render: top-k", img_k, img_p, card)
    print(f"render: trained field, inverse CDF cap 4: training view "
          f"{psnr_train:.2f} dB (JAX package {JAX_TRAIN_PSNR}, gap "
          f"{psnr_train - JAX_TRAIN_PSNR:+.2f}), novel view "
          f"{psnr_novel['cdf']:.2f} dB (JAX package {JAX_NOVEL_PSNR}, gap "
          f"{psnr_novel['cdf'] - JAX_NOVEL_PSNR:+.2f})")
    print(f"render: trained field, top-k cap 8: training view "
          f"{psnr_train_topk:.2f} dB, novel view {psnr_novel['topk']:.2f} dB")
    for name in ("cdf", "topk"):
        print(f"render: {name} {H}x{W}: "
              f"{', '.join(f'{w:.2f}' for w in walls[name])} ms/frame "
              f"(median {float(np.median(walls[name])):.2f}) over "
              f"{len(novel)} novel poses; live rays {outs[name]['live']}, "
              f"chunks/frame {outs[name]['chunks']}; launches "
              f"{launches[name]} for {chunks[name]} chunks ({card})")
    check(psnr_train >= TRAIN_PSNR_MIN, f"training-view PSNR {psnr_train} "
          f"< {TRAIN_PSNR_MIN}")
    check(psnr_novel["cdf"] >= NOVEL_PSNR_MIN, f"novel-view PSNR "
          f"{psnr_novel['cdf']} < {NOVEL_PSNR_MIN}")
    ngp_mesh(trainer, mcfg, dev, card)

    del trainer, params_t, prepass_topk, outs
    torch.cuda.empty_cache()

    # -- 9. the curved model's serving path ----------------------------------
    curved = curved_phase(dev, card, ds, timing)

    # -- 10. curved training, and the trained live, pool and baked frames --
    trained, tr = curved_train_phase(dev, card, ds, timing)

    # -- 11. the texture pipeline on the trained field -----------------------
    texture = texture_phase(dev, card, ds, tr)

    # -- 12. synthesis onto another mesh, and its imports --------------------
    surfaces = surfaces_phase(dev, card, ds, tr, trained["psnr_live"])
    del tr
    torch.cuda.empty_cache()

    # -- 13. the selection kernels' device time vs their bounds -------------
    timed = timing_phase(dev, card)

    print(f"smoke: wall {time.perf_counter() - wall0:.1f} s ({card})")
    cdf_paths = {"ngp_serving_slice": slice_launches,
                 "ngp_trained_render": launches["cdf"],
                 "curved_live": curved["launches"],
                 "curved_trained_live": trained["live"],
                 "curved_baked": trained["baked"],
                 "texture_field": texture["texture_field"],
                 "texture_patch": texture["texture_patch"], **surfaces}

    def kernel_line(name, kind, K, cap, replaces, paths, err, other=()):
        """One kernel's entry of the JSON line at its main-path shape
        [16384, K] cap (device times cold, from HBM, unless _warm), with
        the other timed shapes under ``by_shape``."""
        def cell(key):
            t = timed[key]
            return {"device_us": t["device_us"],
                    "device_us_warm": t["device_us_warm"],
                    "bound_us": t["bound_ms"] * 1e3,
                    "bound_share": t["bound_share"],
                    "wrapper_us": t["wrapper_us"],
                    "copy_us": t["copy_us"],
                    "plain_ms": timing[key[1:]]}
        key = (kind, 16384, K, cap)
        t = timed[key]
        return {"name": name, "route": "cuda",
                "source": "nerf_texture_tpu_torch/csrc/proxy_select.cu",
                "replaces": replaces, "launches": sum(paths.values()),
                "launches_by_path": paths, "max_abs_err": err,
                "ms": t["device_us"] / 1e3,
                "plain_ms": timing[key[1:]], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "shape": f"[16384, {K}] cap {cap}", **cell(key),
                "by_shape": {f"[16384, {K}] cap {c}": cell((kind, 16384, K,
                                                            c))
                             for c in other},
                "card": card}

    print(json.dumps({"kernels": [
        kernel_line("proxy_select_cdf", "cdf", 24, 5,
                    "nerf_texture_tpu/ops/proxy_select.py:96", cdf_paths,
                    max(max_err, curved["max_abs_err"],
                        trained["max_abs_err"]), other=(4,)),
        kernel_line("proxy_select", "topk", 24, 8,
                    "nerf_texture_tpu/ops/proxy_select.py:49",
                    {"ngp_trained_render_topk": launches["topk"],
                     "texture_two_round": texture["texture_two_round"]},
                    topk_err)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
