#!/usr/bin/env python3
"""Scenes larger than the unit cube with the port's NGP trainer, on the
card: main_nerf_torch.py's configuration (``RenderConfig.for_bound(bound,
dt_gamma=..., max_steps=384)``, 4096 rays, seed 0) trained on the
synthetic sphere written as a colmap scene of RGBA PNG frames and of RGB
JPEG frames (quality 95, 4:4:4, composited on white), at bound 1 and 2.

    python3 scripts/torch_bound_probe.py [--iters 500] [--every N]
        [--arms png:1:0,jpeg:1:0,png:2:0.0078125,jpeg:2:0.0078125,png:2:0]

For each arm (scene:bound:dt_gamma) it prints, every ``--every`` steps
(default: once, at the end), it/s, the occupied share of each cascade,
the mean density, and the eval PSNR of training frame 0 (the CLI's eval)
with the inference pool at 24 samples a ray (the default), 64, and
without a pool (the dense [N, K] march), so that a grid that stays
occupied shows in the pool's decimation.  Files go to build/bound_probe/.
"""

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nerf_texture_tpu_torch.data import jpeg  # noqa: E402
from nerf_texture_tpu_torch.data.images import read_png  # noqa: E402
from nerf_texture_tpu_torch.data.provider import NeRFDataset  # noqa: E402
from nerf_texture_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticSphereDataset)
from nerf_texture_tpu_torch.models.ngp import NGPConfig  # noqa: E402
from nerf_texture_tpu_torch.render.renderer import RenderConfig  # noqa: E402
from nerf_texture_tpu_torch.train.trainer import (  # noqa: E402
    TrainConfig, Trainer)

OUT = os.path.join("build", "bound_probe")


def scenes():
    png, jpg = os.path.join(OUT, "png"), os.path.join(OUT, "jpeg")
    shutil.rmtree(OUT, ignore_errors=True)
    SyntheticSphereDataset(n_frames=24, H=400, W=400).write_to_disk(png)
    os.makedirs(os.path.join(jpg, "images"))
    with open(os.path.join(png, "transforms.json")) as f:
        meta = json.load(f)
    for fr in meta["frames"]:
        a = read_png(os.path.join(png, fr["file_path"])).astype(
            np.float32) / 255.0
        rgb = a[..., :3] * a[..., 3:] + (1.0 - a[..., 3:])
        fr["file_path"] = fr["file_path"][:-4] + ".jpg"
        jpeg.write_jpeg(os.path.join(jpg, fr["file_path"]),
                        np.round(rgb * 255).astype(np.uint8), 95, "4:4:4")
    with open(os.path.join(jpg, "transforms.json"), "w") as f:
        json.dump(meta, f)
    return {"png": png, "jpeg": jpg}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--every", type=int, default=0)
    ap.add_argument("--arms", default="png:1:0,jpeg:1:0,png:2:0.0078125,"
                    "jpeg:2:0.0078125,png:2:0")
    args = ap.parse_args()
    every = args.every or args.iters
    if not torch.cuda.is_available():
        sys.exit("torch_bound_probe: needs a CUDA card")
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    print(card)
    paths = scenes()
    for arm in args.arms.split(","):
        scene, bound, dtg = arm.split(":")
        bound, dtg = float(bound), float(dtg)
        ds = NeRFDataset(paths[scene], split="train", scale=0.33)
        rcfg = RenderConfig.for_bound(bound, dt_gamma=dtg, max_steps=384)
        tr = Trainer(ds, NGPConfig(bound=bound), rcfg,
                     TrainConfig(lr=1e-2, total_steps=args.iters,
                                 num_rays=4096), seed=0, device="cuda")
        psnr0 = tr.eval_psnr([0])
        for done in range(every, args.iters + 1, every):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train(every)
            torch.cuda.synchronize()
            its = every / (time.perf_counter() - t0)
            occ = tr.state.occ.occ.reshape(rcfg.cascades, -1).float().mean(1)
            evals = {}
            for pool in (24, 64, 0):
                tr.rcfg = dataclasses.replace(rcfg,
                                              pool_mean_samples_infer=pool)
                t0 = time.perf_counter()
                evals[pool] = (tr.eval_psnr([0]),
                               (time.perf_counter() - t0) * 1e3)
            tr.rcfg = rcfg
            print(f"{scene} bound {bound:g} dt_gamma {dtg:g}: step {done}, "
                  f"{its:.2f} it/s, last loss {m['loss']:.5f}; occupied "
                  f"{[round(float(x), 4) for x in occ]}, mean density "
                  f"{float(tr.state.occ.mean_density):.4f}; eval PSNR "
                  f"{psnr0:.2f} dB at step 0, then pool 24: "
                  f"{evals[24][0]:.2f} ({evals[24][1]:.0f} ms), pool 64: "
                  f"{evals[64][0]:.2f}, dense: {evals[0][0]:.2f} dB ({card})",
                  flush=True)
        del tr
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
