"""Trained curved frames through the selection kernel against their
plain-selection frames, over many poses.

``chip_smoke.py`` holds one trained live frame and one baked frame
against their plain-selection twins.  This script trains the curved
model as the smoke does (the width and 700 steps of ``bench.py``'s
curved arm, seed 7), then renders 10 orbit poses live (K 24 cap 5),
baked (K 16 cap 5) and baked at cap 6 (K 20), each once through
``proxy_select_cdf`` and once through its plain version, and prints a
line a path: PSNR, max abs difference and share of pixels off by
> 1e-3 at each pose.  It needs a CUDA card; run it from the repo root:

    python3 twin_probe.py [TRAININGS]     # default 1
"""

import dataclasses
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from nerf_texture_tpu_torch.data.poses import orbit_pose
from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
from nerf_texture_tpu_torch.geometry.projector import MeshProjector
from nerf_texture_tpu_torch.models import mesh_field
from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train.curved_trainer import (CurvedTrainConfig,
                                                         CurvedTrainer)

PATHS = (("live", {}, {}),
         ("baked", {"baked": True}, cs.CURVED_BAKED),
         ("baked_cap6", {"baked": True},
          {**cs.CURVED_BAKED, **cs.CURVED_BAKED_CAP6}))


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ds = SyntheticSphereDataset(n_frames=8, H=800, W=800)
    poses = [orbit_pose(np.pi / 2 + 0.2 + 0.37 * i, 0.3 - 0.05 * i,
                        ds.radius) for i in range(10)]
    for run in range(int(sys.argv[1]) if len(sys.argv) > 1 else 1):
        t0 = time.time()
        tr = CurvedTrainer(
            ds, mesh_field.make_state(MeshProjector(
                make_icosphere(4, radius=0.5), device=dev)),
            CurvedFieldConfig(field=MeshFieldConfig(), light_model="SH"),
            RenderConfig(**cs.CURVED_RENDER),
            CurvedTrainConfig(**cs.CURVED_TRAIN), seed=7, device=dev)
        tr.initialize_states(1)
        tr.train(cs.CURVED_TRAIN_STEPS)
        torch.cuda.synchronize()
        print(f"run {run}: trained in {time.time() - t0:.1f} s", flush=True)
        for name, kw, cfg in PATHS:
            tr.rcfg = dataclasses.replace(RenderConfig(**cs.CURVED_RENDER),
                                          **cfg)
            rows = []
            for p in poses:
                k = tr.render_frame(p, use_ema=False, **kw)["image"]
                q = tr.render_frame(p, use_ema=False, plain_select=True,
                                    **kw)["image"]
                k, q = k.cpu().numpy(), q.cpu().numpy()
                d = np.abs(k - q)
                rows.append((cs.psnr(q, k), float(d.max()),
                             float(np.mean(d.max(-1) > 1e-3))))
            print(f"run {run} {name}: " + "; ".join(
                f"{a:.1f} dB {b:.4f} {c:.1e}" for a, b, c in rows),
                flush=True)
        del tr
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
