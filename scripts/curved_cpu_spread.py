"""Train the curved model in both packages on the CPU, past the lockstep,
and print their held-out PSNR cells side by side (ROADMAP Queue 3, items
1 and 2, measurement (a)).

Both trainers start from the same params (the JAX trainer's seeded
params, converted), the same occupancy grid and the same anchor table;
each then draws its own random streams (JAX's keys, the port's
``torch.Generator``) for ``--steps`` steps of the bench's schedule
(a refresh every 16 steps).  At the end each renders the bench's novel
pose: live, pool (``parity=True``), EMA parity, the live field at the
baked arm's settings (block 8, tau_cull 0.1, K 16, cap 5) and the baked
atlas at the same settings.  One JSON line a seed, then the spreads.

Width: the small configs of ``tests/test_torch_curved_train.py``
(3 levels x 2 channels, grid 16, ``make_icosphere(2, 0.5)``) at 32x32
with 8 frames and 256 rays a step; the bench's own width is too large
to train on a shared CPU host.

    python scripts/curved_cpu_spread.py --seeds 0 1 2 --steps 700
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from nerf_texture_tpu.data.synthetic import (  # noqa: E402
    SyntheticSphereDataset)
from nerf_texture_tpu.geometry.mesh import (  # noqa: E402
    make_icosphere as jax_icosphere)
from nerf_texture_tpu.geometry.projector import (  # noqa: E402
    MeshProjector as JaxMeshProjector)
from nerf_texture_tpu.models import curved_field as jcf  # noqa: E402
from nerf_texture_tpu.models import mesh_field as jmf  # noqa: E402
from nerf_texture_tpu.render import renderer as jr  # noqa: E402
from nerf_texture_tpu.train import curved_trainer as jct  # noqa: E402
from nerf_texture_tpu_torch.convert import (  # noqa: E402
    occupancy_from_jax, params_from_jax)
from nerf_texture_tpu_torch.data import synthetic as tsyn  # noqa: E402
from nerf_texture_tpu_torch.data.poses import orbit_pose  # noqa: E402
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere  # noqa: E402
from nerf_texture_tpu_torch.geometry.projector import (  # noqa: E402
    MeshProjector)
from nerf_texture_tpu_torch.models import curved_field as tcf  # noqa: E402
from nerf_texture_tpu_torch.models import mesh_field as tmf  # noqa: E402
from nerf_texture_tpu_torch.render.renderer import RenderConfig  # noqa: E402
from nerf_texture_tpu_torch.train import curved_trainer as tct  # noqa: E402
from nerf_texture_tpu_torch.utils.metrics import psnr  # noqa: E402

FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=True)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
RENDER = dict(bound=1.0, cascades=1, grid_size=16, max_steps=48,
              max_samples_train=24, max_samples_infer=32, ray_chunk=1024,
              pool_mean_samples=16, pool_mean_samples_infer=16,
              proxy_samples=0, proxy_refined=24, infer_color_cap=5)
TRAIN = dict(lr=1e-2, total_steps=4000, num_rays=256,
             grid_update_interval=16, grid_full_updates=0)
BAKED = dict(prepass_block=8, prepass_tau_cull=0.1, proxy_refined=16)
HW = 32


def cells(tr, gt, jax_side: bool):
    """The held-out PSNR cells of one trainer at the novel pose."""
    pose = orbit_pose(np.pi / 2 + 0.2, 0.3, 2.0)

    def frame(**kw):
        img = tr.render_frame(pose, **kw)["image"]
        return float(psnr(np.asarray(img) if jax_side else img, gt))

    out = {"live": frame(use_ema=False), "pool": frame(use_ema=False,
                                                         parity=True),
           "ema_parity": frame(use_ema=True, parity=True)}
    rcfg = tr.rcfg
    tr.rcfg = dataclasses.replace(rcfg, **BAKED)
    out["live_k16"] = frame(use_ema=False)
    out["baked_k16"] = frame(use_ema=False, baked=True)
    tr.rcfg = rcfg
    return out


def run(seed: int, steps: int) -> dict:
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**FIELD), **MODEL)
    ct = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**FIELD), **MODEL)
    rj = jr.RenderConfig(**RENDER)
    rt = RenderConfig(**dataclasses.asdict(rj))
    ds = SyntheticSphereDataset(n_frames=8, H=HW, W=HW)
    tj = jct.CurvedTrainer(ds, jmf.make_state(JaxMeshProjector(
        jax_icosphere(2, radius=0.5))), cj, rj,
        jct.CurvedTrainConfig(**TRAIN), key=jax.random.PRNGKey(seed))
    tj.initialize_states(1)
    tab = np.array(tj._anchor_table())
    st = tmf.make_state(MeshProjector(make_icosphere(2, radius=0.5),
                                      device="cpu"))
    tt = tct.CurvedTrainer(tsyn.SyntheticSphereDataset(n_frames=8, H=HW,
                                                        W=HW),
                           st, ct, rt, tct.CurvedTrainConfig(**TRAIN),
                           seed=seed, device="cpu")
    tt.state = tct.init_curved_state(
        tt.generator, ct, rt, tt.tcfg,
        params=params_from_jax(jax.tree.map(np.asarray, tj.state.params),
                               device="cpu"))
    o = tj.state.occ
    tt.state.occ = occupancy_from_jax(o.density, o.occ, o.mean_density,
                                      o.iter_density, device="cpu")
    tt._anchor_tab = (st.projector, True, torch.from_numpy(tab))
    pose = orbit_pose(np.pi / 2 + 0.2, 0.3, 2.0)
    gt = tsyn.render_gt_sphere(pose, tt.dataset.intrinsics, HW, HW, 0.5)
    gt = gt.astype(np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    t0 = time.perf_counter()
    tj.train(steps)
    t1 = time.perf_counter()
    tt.train(steps)
    t2 = time.perf_counter()
    return {"seed": seed, "steps": steps, "jax_s": round(t1 - t0, 1),
            "port_s": round(t2 - t1, 1), "jax": cells(tj, gt, True),
            "port": cells(tt, gt, False)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=700)
    args = ap.parse_args()
    torch.set_num_threads(2)
    rows = []
    for seed in args.seeds:
        rows.append(run(seed, args.steps))
        print(json.dumps(rows[-1]), flush=True)
    keys = rows[0]["jax"].keys()
    spread = {k: {"jax": [r["jax"][k] for r in rows],
                  "port": [r["port"][k] for r in rows],
                  "port_minus_jax_mean": float(np.mean(
                      [r["port"][k] - r["jax"][k] for r in rows]))}
              for k in keys}
    for side in ("jax", "port"):
        spread[f"{side}_pool_minus_baked_k16"] = [
            r[side]["pool"] - r[side]["baked_k16"] for r in rows]
        spread[f"{side}_pool_minus_live_k16"] = [
            r[side]["pool"] - r[side]["live_k16"] for r in rows]
    print(json.dumps({"spread": spread}), flush=True)


if __name__ == "__main__":
    main()
