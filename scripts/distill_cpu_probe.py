"""What distillation costs the curved field in both packages, on the CPU
(the entry-point smoke's distilled curved run stays near an empty
frame's PSNR; PERF.md §6, PR 8).

One scene and one template for every run: the port's
``SyntheticSphereDataset(12, 96x96)`` written as a scene directory,
``main_nerf_torch.py`` (600 steps, 2048 rays, ``--save_mesh`` at 128^3)
on the CPU, and ``main_torch.build_template_mesh`` of its mesh.  Then
the curved model of the scene-directory preset, camera optimisation off,
1024 rays, trains ``--steps`` steps in each variant and prints the EMA
and live PSNR of the eval frame every 100 steps:

  port, port_distill     -- the port without / with ``--distillation``
                            (the NGP checkpoint as the teacher)
  port_distill_table     -- the port with distillation whose samples
                            anchor through the per-cell anchor table (as
                            the RGB steps do) in place of each ray's kNN
                            frame: a probe of the cause, not the port's
                            behaviour
  jax, jax_distill       -- the JAX package's trainer on the same files,
                            the teacher converted from the port's
                            checkpoint

Width, narrowed in this process for the CPU: NGP 8 levels x 2, 2^12
bricks, resolution 256, hidden 32; the field's grids as the NGP's; the
render grid 64.

    python scripts/distill_cpu_probe.py [--steps 100] [--variants ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nerf_texture_tpu import config as jconfig  # noqa: E402
from nerf_texture_tpu.models import ngp as jngp  # noqa: E402
from nerf_texture_tpu.render import renderer as jrend  # noqa: E402
from nerf_texture_tpu_torch import config as tconfig  # noqa: E402
from nerf_texture_tpu_torch.models import ngp as tngp  # noqa: E402
from nerf_texture_tpu_torch.render import renderer as trend  # noqa: E402

NGP = dict(num_levels=8, level_dim=2, log2_bricks=12,
           desired_resolution=256, hidden_dim=32, hidden_dim_color=32)
FIELD = dict(level_dim=2, base_resolution=16, desired_resolution=256,
             log2_bricks=12)
RENDER = dict(grid_size=64, ray_chunk=4096)


def narrow():
    """The widths above, for both packages' configs and the CLIs."""
    tngp.NGPConfig = functools.partial(tngp.NGPConfig, **NGP)
    for cfg_mod in (tconfig, jconfig):
        cfg_mod.MeshFieldConfig = functools.partial(cfg_mod.MeshFieldConfig,
                                                    **FIELD)
    for rend in (trend, jrend):
        for_bound = rend.RenderConfig.for_bound
        rend.RenderConfig.for_bound = staticmethod(
            lambda b, _f=for_bound, **kw: _f(b, **{**RENDER, **kw}))


def port_trainer(scene, ws, template, distill: bool, table: bool):
    from nerf_texture_tpu_torch.data.provider import NeRFDataset
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.train import curved_trainer as tct

    cfg = tconfig.get_preset(scene)
    tcfg = dataclasses.replace(cfg.curved_train, num_rays=1024,
                               optimize_camera=False, distillation=distill)
    teacher = (tct.load_ngp_teacher(ws, tngp.NGPConfig(bound=1.0),
                                    device="cpu") if distill else None)
    ds = NeRFDataset(scene, split="train", scale=cfg.scale)
    tr = tct.CurvedTrainer(ds, mesh_field.make_state(MeshProjector(
        template, device="cpu")), cfg.curved, cfg.render, tcfg,
        device="cpu", teacher=teacher)
    if table:
        # the probe: while a distillation loss runs, the field reads the
        # anchor table's frames at every sample
        tab = tr._refresh_anchor_tab()
        inside = [False]
        distill_loss, forward = tct.distill_loss, tct.curved_field.forward

        def probed_loss(*a, **k):
            inside[0] = True
            try:
                return distill_loss(*a, **k)
            finally:
                inside[0] = False

        def probed_forward(params, state, x, d, cfg, rt=None, *,
                           frames=None, **k):
            if inside[0]:
                frames = tct.proj.anchor_frames_from_table(
                    tab, x, torch.ones(x.shape[:1], dtype=torch.bool),
                    cfg.bound)
            return forward(params, state, x, d, cfg, rt, frames=frames, **k)

        tct.distill_loss = probed_loss
        tct.curved_field.forward = probed_forward
    return tr


def jax_trainer(scene, ws, distill: bool):
    from nerf_texture_tpu.data.provider import NeRFDataset
    from nerf_texture_tpu.geometry.mesh import load_obj
    from nerf_texture_tpu.geometry.projector import MeshProjector
    from nerf_texture_tpu.models import mesh_field
    from nerf_texture_tpu.train.curved_trainer import CurvedTrainer
    from nerf_texture_tpu_torch.train.trainer import read_checkpoint

    cfg = jconfig.get_preset(scene)
    tcfg = dataclasses.replace(cfg.curved_train, num_rays=1024,
                               optimize_camera=False, scan_steps=1,
                               distillation=distill)
    teacher = None
    if distill:
        raw = read_checkpoint(os.path.join(ws, "checkpoints", "ngp"))
        tp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), raw["params"],
                          is_leaf=torch.is_tensor)
        teacher = (tp, jngp.NGPConfig(bound=1.0, **NGP))
    ds = NeRFDataset(scene, split="train", scale=cfg.scale)
    template = load_obj(os.path.join(ws, "meshes",
                                     "surface_coacd_remesh.obj"))
    return CurvedTrainer(ds, mesh_field.make_state(MeshProjector(template)),
                         cfg.curved, cfg.render, tcfg,
                         key=jax.random.PRNGKey(0), teacher=teacher)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--out", default=os.path.join("build", "distill_probe"))
    ap.add_argument("--variants", nargs="+",
                    default=["port", "port_distill", "port_distill_table",
                             "jax", "jax_distill"])
    args = ap.parse_args()
    narrow()
    import main_nerf_torch
    import main_torch
    from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset

    scene, ws = os.path.join(args.out, "scene"), os.path.join(args.out, "ws")
    if not os.path.exists(os.path.join(ws, "meshes", "ngp_mesh.obj")):
        SyntheticSphereDataset(n_frames=12, H=96, W=96).write_to_disk(scene)
        main_nerf_torch.main([scene, "--workspace", ws, "--iters", "600",
                              "--eval_interval", "300", "--num_rays", "2048",
                              "--save_mesh", "--mesh_resolution", "128",
                              "--device", "cpu"])
    template = main_torch.build_template_mesh(tconfig.get_preset(scene), ws)
    print(f"template: {len(template.vertices)} vertices", flush=True)
    for variant in args.variants:
        distill = "distill" in variant
        tr = (jax_trainer(scene, ws, distill) if variant.startswith("jax")
              else port_trainer(scene, ws, template, distill,
                                variant.endswith("table")))
        t0 = time.time()
        for _ in range(args.steps // 100):
            out = tr.train(100)
            print(f"{variant} step {int(tr.state.step)}: loss "
                  f"{out['loss']:.5f}, eval PSNR {tr.eval_psnr([0]):.2f} dB "
                  f"(EMA), {tr.eval_psnr([0], use_ema=False):.2f} dB "
                  f"(live); {time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()
