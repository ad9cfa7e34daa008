#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port ``nerf_texture_tpu_torch`` on a GPU.

    python3 chip_smoke.py

Drives the port's serving path -- an 800x800 novel view of the NGP at the
width ``bench.py`` uses -- through the entry point a user calls
(``train.trainer.render_frame``), and checks it.  Phases, in order; any
failure ends the run with a non-zero exit and no result line:

  1. device:  a CUDA card is required (there is no CPU path); prints the
              card's name and power limit as nvidia-smi gives them;
  2. build:   builds the proxy_select_cdf kernel from csrc/ (nvcc, sm_90a);
  3. kernel:  kernel vs its plain PyTorch version on the card, at the
              main path's shape [16384, 24] cap 4 and at [8192, 16] cap 5,
              with degenerate spans, empty rays and ties; times both;
  4. parity:  a small frame rendered by the port on the card vs the same
              frame by the port on the CPU (whose numerics the tier-1 tests
              hold against the JAX package);
  5. slice:   seeded full-width NGP params over a fixture density shell,
              800x800 frames at novel orbit poses: shape, range, live
              count, kernel launches == chunks, and one frame re-rendered
              with the plain selection agrees.

Prints a ``{"kernels": [...]}`` JSON line before the last, and as the last
line ``{"ok": true, "device": {...}}``.  Needs one card, the CUDA toolkit
(nvcc) and no network; the kernel build goes to build/kernels/.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances (each with its reason):
# kernel vs plain selection: t values within 1e-5 (float summation order
# may differ in the last bits; the kernel compiles with --fmad=false and
# the same scan association, so it usually agrees exactly); valid equal.
SELECT_ATOL = 1e-5
# a frame on the card vs on the CPU: bf16 rounding of the MLP activations
# and of the table products can fall differently after a last-bit
# difference in f32 sums, and a prepass hit test on a cell border can
# flip a block; the same bounds as the JAX-parity test of the slice.
FRAME_PSNR_MIN = 45.0
FRAME_MAX_ABS = 5e-2
FRAME_LIVE_MISMATCH = 0.005
# kernel frame vs plain-selection frame on the card: the selections
# agree within SELECT_ATOL in t, but where a ray's CDF plateaus (an empty
# gap between the front and back crossings of the shell) at a level
# within rounding of a quantile u, the quantile jumps across the gap in
# one version and not the other: a few such pixels differ by up to a
# sample's contribution.  So the bound is on the frame's PSNR and on the
# share of pixels that differ by more than 1e-3.
TWIN_FRAME_PSNR_MIN = 60.0
TWIN_FRAME_MAX_ABS = 5e-2
TWIN_FRAME_OFF_SHARE = 1e-3

BENCH_NGP = dict(bound=1.0, num_levels=8, level_dim=4, log2_bricks=16,
                 desired_resolution=2048)
# RenderConfig of bench.py's NGP arm
BENCH_RENDER = dict(bound=1.0, cascades=1, grid_size=128, max_steps=384,
                    max_samples_train=192, max_samples_infer=96,
                    ray_chunk=16384, pool_mean_samples=64,
                    pool_mean_samples_infer=24, proxy_samples=0,
                    proxy_refined=24, infer_color_cap=4, prepass_block=8,
                    prepass_tau_cull=0.1)
SMALL_NGP = dict(bound=1.0, num_levels=4, level_dim=4, log2_bricks=10,
                 desired_resolution=256)
SMALL_RENDER = dict(bound=1.0, cascades=1, grid_size=32, ray_chunk=1024,
                    proxy_samples=0, proxy_refined=24, infer_color_cap=4,
                    prepass_block=8, prepass_tau_cull=0.1)
# U(-1e-4, 1e-4) init tables give features ~1e-4 and a flat sigma ~1;
# scaled by 1e4 the seeded field has sigma from ~0.1 to ~10 and varied
# colour, so the frame composites real structure.
TABLE_SCALE = 1e4


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


def seeded_params(ngp, mcfg, generator):
    params = ngp.init(generator, mcfg)
    params["grid"] = params["grid"] * TABLE_SCALE
    return params


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
    # Every matmul on the path multiplies bf16-rounded operands, which
    # TF32 holds exactly, with f32 accumulation: TF32 changes no product,
    # so the tensor cores may run the MLPs.
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    from nerf_texture_tpu_torch import kernels
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.data.synthetic import (shell_occupancy,
                                                       sphere_intrinsics)
    from nerf_texture_tpu_torch.models import ngp
    from nerf_texture_tpu_torch.ops.proxy_select import (
        proxy_select_cdf, proxy_select_cdf_reference)
    from nerf_texture_tpu_torch.render.renderer import (PrepassState,
                                                        RenderConfig)
    from nerf_texture_tpu_torch.train.trainer import (ngp_infer_params,
                                                      render_frame)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build = kernels.build("proxy_select")
    kernels.load_library("proxy_select")
    print(f"build: proxy_select {build.path.name} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {build.seconds:.2f} s)")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 3. kernel vs plain version on the card ------------------------------
    max_err = 0.0
    timing = {}
    for seed, (N, K, cap) in enumerate([(16384, 24, 4), (8192, 16, 5)]):
        args = selection_inputs(N, K, seed, dev)
        got = proxy_select_cdf(*args, cap=cap, w_eps=1e-4)
        ref = proxy_select_cdf_reference(*args, cap=cap, w_eps=1e-4)
        torch.cuda.synchronize()
        err = max(float((got[i] - ref[i]).abs().max()) for i in (0, 1))
        check(err <= SELECT_ATOL, f"kernel vs plain at [{N}, {K}] cap "
              f"{cap}: max abs err {err} > {SELECT_ATOL}")
        check(bool(torch.equal(got[2], ref[2])),
              f"kernel vs plain valid2 differ at [{N}, {K}] cap {cap}")
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: proxy_select_cdf(*args, cap=cap, w_eps=1e-4))
        plain = cuda_ms(lambda: proxy_select_cdf_reference(
            *args, cap=cap, w_eps=1e-4))
        timing[(N, K, cap)] = (ms, plain)
        print(f"kernel: proxy_select_cdf [{N}, {K}] cap {cap}: max abs err "
              f"{err:.3g}; kernel {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} "
              f"us ({card})")

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

    def frame(pose, select_cdf=None):
        return render_frame(iparams, None, pose, intr, H, W, mcfg, rcfg,
                            prepass=prepass, select_cdf=select_cdf)

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
    img_p = frame(poses[1], select_cdf=proxy_select_cdf_reference)[
        "image"].cpu().numpy()
    twin_err = float(np.abs(img_p - img_k).max())
    twin_psnr = psnr(img_p, img_k)
    twin_off = float(np.mean(np.abs(img_p - img_k).max(-1) > 1e-3))
    print(f"slice: kernel frame vs plain-selection frame: PSNR "
          f"{twin_psnr:.2f} dB, max abs {twin_err:.3g}, pixels off by "
          f"> 1e-3: {twin_off:.2e}")
    check(twin_psnr >= TWIN_FRAME_PSNR_MIN and twin_err <= TWIN_FRAME_MAX_ABS
          and twin_off <= TWIN_FRAME_OFF_SHARE,
          f"kernel frame vs plain-selection frame: PSNR {twin_psnr} dB, max "
          f"abs {twin_err}, share off {twin_off}")
    lives = [out["live"] for out in outs]
    print(f"slice: {H}x{W} frames: {', '.join(f'{w:.2f}' for w in walls)} "
          f"ms/frame (median {float(np.median(walls)):.2f}) over "
          f"{len(walls)} novel poses; live rays {lives}; chunks/frame "
          f"{[out['chunks'] for out in outs]}; proxy_select_cdf launches "
          f"{launches}; peak memory {peak_mb:.1f} MiB ({card})")

    ms, plain = timing[(16384, 24, 4)]
    print(json.dumps({"kernels": [{
        "name": "proxy_select_cdf", "route": "cuda",
        "source": "nerf_texture_tpu_torch/csrc/proxy_select.cu",
        "replaces": "nerf_texture_tpu/ops/proxy_select.py:96",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
