#!/usr/bin/env python3
"""The NGP's learned background sphere with the port's trainer, on the
card: ``chip_smoke.py`` phase 17's model (NGPConfig's defaults with
``encoder='hash'`` and ``bg_radius`` 4) and phase 7's schedule (bench.py's
NGP arm, 50 + 650 steps, 4096 rays) on the synthetic sphere's 8 frames
at 800x800, in three arms that differ in what lies behind the sphere:

  white   the RGBA frames with ``random_bg`` off (the sphere on white);
  random  the RGBA frames with ``random_bg`` on (a new background colour
          each step, as bench.py trains the packed NGP);
  env     RGB frames of the sphere in front of an environment (a smooth
          colour field over the view direction), as a capture with a
          real background;
  room    RGB frames of the sphere inside a painted sphere of the
          background's radius (``chip_smoke.RoomScene``): the background
          moves with parallax between the cameras, as a real one does;
  plain   the per-corner encoder without a background sphere, on the RGBA
          frames with ``random_bg`` on (phase 7's setting).

    python3 scripts/torch_background_probe.py
        [--arms white,random,env,room,plain] [--steps 700]

For each arm it prints it/s, the occupied share of the grid, the mean
samples a ray, the learned background's mean colour on the rays that
composite no weight, and the PSNR of training view 0 and of a novel view
through the CDF selection (cap 4) against the frame's ground truth:
the sphere on white (white, plain), on white and on the learned
background image (random), on the environment (env), in the room
(room).
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from nerf_texture_tpu_torch.data.poses import orbit_pose  # noqa: E402
from nerf_texture_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticSphereDataset, render_gt_sphere)
from nerf_texture_tpu_torch.models.ngp import NGPConfig  # noqa: E402
from nerf_texture_tpu_torch.render.renderer import RenderConfig  # noqa: E402
from nerf_texture_tpu_torch.train.trainer import (  # noqa: E402
    TrainConfig, Trainer, ngp_background_image)
from nerf_texture_tpu_torch.utils.metrics import psnr  # noqa: E402


def environment(pose, intrinsics, H, W):
    """[H, W, 3] colour of the view direction of each pixel: a smooth
    field over the sphere of directions."""
    fx, fy, cx, cy = intrinsics
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    d = np.stack([(i + 0.5 - cx) / fx, (j + 0.5 - cy) / fy,
                  np.ones_like(i)], -1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True) @ pose[:3, :3].T
    az, el = np.arctan2(d[..., 2], d[..., 0]), np.arccos(np.clip(
        d[..., 1], -1, 1))
    return np.stack([0.5 + 0.35 * np.sin(2 * az) * np.sin(el),
                     0.5 + 0.35 * np.cos(3 * el),
                     0.5 + 0.3 * np.sin(az + el)], -1).astype(np.float32)


def sphere_over(pose, ds, background):
    gt = render_gt_sphere(pose, ds.intrinsics, ds.H, ds.W,
                          ds.sphere_radius).astype(np.float32) / 255.0
    return gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:]) * background


class EnvScene:
    """The synthetic sphere's cameras with RGB frames over
    ``environment``."""

    def __init__(self, ds):
        self.poses, self.intrinsics = ds.poses, ds.intrinsics
        self.H, self.W, self.num_frames = ds.H, ds.W, ds.num_frames
        self.radius, self.sphere_radius = ds.radius, ds.sphere_radius
        self.images = np.stack([np.round(np.clip(sphere_over(
            p, ds, environment(p, ds.intrinsics, ds.H, ds.W)), 0, 1)
            * 255).astype(np.uint8) for p in ds.poses])


def arm(name, ds, steps, dev, card):
    mcfg = NGPConfig(**chip_smoke.BG_NGP, bg_radius=(
        -1.0 if name == "plain" else chip_smoke.BG_RADIUS))
    rcfg = RenderConfig(**chip_smoke.BENCH_RENDER)
    tcfg = TrainConfig(**chip_smoke.BENCH_TRAIN,
                       random_bg=name in ("random", "plain"))
    scene = {"env": EnvScene, "room": chip_smoke.RoomScene}.get(
        name, lambda d: d)(ds)
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = Trainer(scene, mcfg, rcfg, tcfg, seed=7, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = tr.train(steps)
    torch.cuda.synchronize()
    its = steps / (time.perf_counter() - t0)
    torch.backends.cuda.matmul.allow_tf32 = True
    occ = tr.state.occ
    novel = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    out = {}
    for view, pose in (("train", ds.poses[0]), ("novel", novel)):
        f = tr.render_frame(pose, use_ema=False)
        img = f["image"].cpu().numpy()
        bg = (ngp_background_image(tr.state.params, pose, ds.intrinsics,
                                   H=ds.H, W=ds.W, mcfg=mcfg).detach()
              .reshape(ds.H, ds.W, 3).cpu().numpy()
              if mcfg.bg_radius > 0 else np.ones((ds.H, ds.W, 3)))
        miss = f["weights_sum"].cpu().numpy() == 0
        truth = {"white": sphere_over(pose, ds, 1.0)}
        if name == "random":
            truth["learned background"] = sphere_over(pose, ds, bg)
        if name == "env":
            truth = {"environment": sphere_over(pose, ds, environment(
                pose, ds.intrinsics, ds.H, ds.W))}
        if name == "room":
            truth = {"room": chip_smoke.room_gt(ds, pose)}
        out[view] = ", ".join(f"{k} {psnr(img, v):.2f} dB"
                              for k, v in truth.items())
        out[view + "_bg"] = (bg[miss].mean(0).round(3).tolist()
                             if miss.any() else None)
        out[view + "_live"] = f["live"]
    print(f"background probe: {name}: {steps} steps, {its:.2f} it/s, loss "
          f"{m['loss']:.5f}, samples/ray {m['mean_samples']:.1f}; "
          f"{float(occ.occ.float().mean()) * 100:.1f}% of the grid "
          f"occupied; training view {out['train']} (live {out['train_live']},"
          f" background on the misses {out['train_bg']}); novel view "
          f"{out['novel']} (live {out['novel_live']}, background "
          f"{out['novel_bg']}) ({card})", flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--arms", default="white,random,env,room,plain")
    p.add_argument("--steps", type=int, default=700)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_background_probe: needs a CUDA card")
    card = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    ds = SyntheticSphereDataset(n_frames=8, H=800, W=800)
    for name in args.arms.split(","):
        arm(name, ds, args.steps, dev, card)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
