"""What the NGP's learned background sphere does to the density grid, in
both packages, on the CPU (the sphere arm of ``chip_smoke.py`` phase 17
keeps every cell of its grid occupied on the card; PERF.md).

The synthetic sphere's 8 cameras at 64x64, and for each package two
arms trained ``--steps`` steps with bench.py's NGP TrainConfig (2048
rays):

  plain   the per-corner NGP without a background sphere on the RGBA
          frames, ``random_bg`` on (bench.py's NGP setting);
  sphere  the same NGP with a background sphere of radius 4 on RGB
          frames of the sphere inside a room painted at that radius
          (``chip_smoke.RoomScene``, phase 17's scene).

Each prints, every 100 steps, the occupied share of the grid, the mean
samples a ray and the loss, and at the end the PSNR of training view 0
and of a novel view through the CDF selection against the frame's
ground truth.  Width, narrowed for the CPU: the per-corner grid 8
levels x 2, 2^14 rows a level, resolution 256, hidden 32; the render
grid 32.

    python scripts/background_cpu_probe.py [--steps 600] [--arms ...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from nerf_texture_tpu.models import ngp as jngp  # noqa: E402
from nerf_texture_tpu.render import renderer as jrend  # noqa: E402
from nerf_texture_tpu.train import trainer as jtrain  # noqa: E402
from nerf_texture_tpu_torch.data.poses import orbit_pose  # noqa: E402
from nerf_texture_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticSphereDataset)
from nerf_texture_tpu_torch.models import ngp as tngp  # noqa: E402
from nerf_texture_tpu_torch.render import renderer as trend  # noqa: E402
from nerf_texture_tpu_torch.train import trainer as ttrain  # noqa: E402
from nerf_texture_tpu_torch.utils.metrics import psnr  # noqa: E402

NGP = dict(encoder="hash", num_levels=8, level_dim=2, log2_hashmap_size=14,
           desired_resolution=256, hidden_dim=32, hidden_dim_color=32)
RENDER = dict(chip_smoke.BENCH_RENDER, grid_size=32, ray_chunk=4096)
TRAIN = dict(chip_smoke.BENCH_TRAIN, num_rays=2048)
HW = 64


def run(package: str, arm: str, steps: int):
    ds = SyntheticSphereDataset(n_frames=8, H=HW, W=HW)
    sphere = arm == "sphere"
    scene = chip_smoke.RoomScene(ds) if sphere else ds
    radius = chip_smoke.BG_RADIUS if sphere else -1.0
    novel = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    poses = {"train": ds.poses[0], "novel": novel}
    gts = {v: (chip_smoke.room_gt(ds, p) if sphere else
               chip_smoke.white_gt(ds, p)) for v, p in poses.items()}
    if package == "jax":
        tr = jtrain.Trainer(scene, jngp.NGPConfig(**NGP, bg_radius=radius),
                            jrend.RenderConfig(**RENDER),
                            jtrain.TrainConfig(**TRAIN),
                            key=jax.random.PRNGKey(7))
        occupied = lambda: float(jnp.mean(tr.state.occ.occ))  # noqa: E731
    else:
        tr = ttrain.Trainer(scene, tngp.NGPConfig(**NGP, bg_radius=radius),
                            trend.RenderConfig(**RENDER),
                            ttrain.TrainConfig(**TRAIN), seed=7,
                            device="cpu")
        occupied = lambda: float(  # noqa: E731
            tr.state.occ.occ.float().mean())
    t0 = time.perf_counter()
    for done in range(100, steps + 1, 100):
        m = tr.train(100)
        print(f"{package} {arm}: step {done}: loss {m['loss']:.5f}, "
              f"samples/ray {m['mean_samples']:.1f}, "
              f"{occupied() * 100:.1f}% of the grid occupied "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    out = {v: psnr(np.asarray(tr.render_frame(p, use_ema=False)["image"]),
                   gts[v]) for v, p in poses.items()}
    print(f"{package} {arm}: CDF frames {out['train']:.2f} / "
          f"{out['novel']:.2f} dB (training / novel view)", flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--arms", default="jax:plain,port:plain,jax:sphere,"
                                     "port:sphere")
    args = p.parse_args()
    torch.set_num_threads(4)
    for item in args.arms.split(","):
        package, arm = item.split(":")
        run(package, arm, args.steps)


if __name__ == "__main__":
    main()
