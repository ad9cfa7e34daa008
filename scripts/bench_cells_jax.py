"""The JAX package's bench-width PSNR cells on the CPU in f32, and the
port's frames from JAX's trained params against JAX's own frames
(ROADMAP Queue 3, items 1 and 2).

The JAX package sets no matmul precision, so its ``BENCH_r05.json``
cells were taken at a TPU's default of one bf16 pass; on the CPU its f32
products are f32, as the port's are on the card with TF32 off.

Stage ``jax`` trains bench.py's two arms with their configs copied
verbatim (bench.py's own CPU branch shrinks them, so it is not called):

- NGP: ``bench.py:72-102`` (800x800, 8 frames, ``PRNGKey(7)``), 50 + 650
  steps; the PSNR of training view 0 and of the novel view
  ``orbit_pose(pi / 2 + 0.2, 0.3, 2)``.
- curved: ``bench.py:340-385`` (``make_icosphere(4)``, ``PRNGKey(7)``,
  ``initialize_states(1)``, 17 + 48 + 635 steps); at the novel pose the
  live, pool and EMA parity frames, then (``bench.py:455-476``) the live
  field at K 16 / block 8 / tau_cull 0.1 / cap 5, the baked frame there
  and the baked frame at K 20 cap 6.

It records PSNR only (no time of the JAX package is a result) and saves
the trained params, EMA params, occupancy grids and the anchor table to
``build/bench_cells/<arm>.npz``, one JSON line an arm to
``build/bench_cells/jax.jsonl``.

Stage ``port`` loads those files, renders the same frames through the
JAX package and through the port on the CPU (params converted by
``convert.params_from_jax``, grids by ``occupancy_from_jax``, the same
anchor table) at 400x400 (the intrinsics scaled from 800x800),
and holds each port frame against JAX's with PR 3's frame bounds: PSNR
>= 45 dB, max abs <= 5e-2, <= 0.5% of pixels live (weights_sum > 0) in
one frame only.  One JSON line an arm
to ``build/bench_cells/port.jsonl``.

    python scripts/bench_cells_jax.py --stage jax --arm curved   # ~1 h
    python scripts/bench_cells_jax.py --stage jax --arm curved --seed 8
    python scripts/bench_cells_jax.py --stage jax --arm ngp
    python scripts/bench_cells_jax.py --stage port
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

OUT = os.path.join(ROOT, "build", "bench_cells")
HW = 800
# the port stage's frames: 400x400, the intrinsics scaled from 800x800
# (the 800x800 frames of both packages take too long on a CPU)
FRAME_HW = 400
# bench.py:72-102, the NGP arm on a TPU
NGP = dict(bound=1.0, num_levels=8, level_dim=4, log2_bricks=16,
           desired_resolution=2048)
NGP_RENDER = dict(bound=1.0, cascades=1, grid_size=128, max_steps=384,
                  max_samples_train=192, max_samples_infer=96,
                  ray_chunk=16384, pool_mean_samples=64,
                  pool_mean_samples_infer=24, proxy_samples=0,
                  proxy_refined=24, infer_color_cap=4, prepass_block=8,
                  prepass_tau_cull=0.1)
NGP_TRAIN = dict(lr=1e-2, total_steps=2000, num_rays=4096, grid_decay=0.85)
NGP_STEPS = (50, 650)
# bench.py:340-367, the curved arm at full size
CURVED_RENDER = dict(bound=1.0, cascades=1, grid_size=128, max_steps=512,
                     max_samples_train=128, max_samples_infer=96,
                     ray_chunk=16384, pool_mean_samples=64,
                     pool_mean_samples_infer=24, march_steps_infer=256,
                     proxy_samples=0, proxy_refined=24, infer_color_cap=5)
CURVED_TRAIN = dict(lr=1e-2, total_steps=4000, num_rays=4096,
                    grid_update_interval=16, grid_full_updates=0)
CURVED_STEPS = (17, 48, 635)            # bench.py:368-385, 700 in all
# bench.py:455-476, the baked arm and its cap-6 quality line
BAKED = dict(prepass_block=8, prepass_tau_cull=0.1, proxy_refined=16)
BAKED_CAP6 = dict(infer_color_cap=6, proxy_refined=20)
SEED = 7
# PR 3's bounds on a port frame against the JAX package's
FRAME_PSNR_MIN, FRAME_MAX_ABS, LIVE_OFF_MAX = 45.0, 5e-2, 5e-3


def novel_pose():
    from nerf_texture_tpu.data.poses import orbit_pose
    return orbit_pose(np.pi / 2 + 0.2, 0.3, 2.0)


def white_gt(pose, intrinsics, H, W):
    from nerf_texture_tpu.data.synthetic import render_gt_sphere
    gt = render_gt_sphere(pose, intrinsics, H, W, 0.5)
    rgb = gt[..., :3].astype(np.float32) / 255.0
    a = gt[..., 3:].astype(np.float32) / 255.0
    return rgb * a + (1.0 - a)


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict of arrays as {"a/b/c": array}; a list of layers stays
    one object array (``np.load(..., allow_pickle=True)`` reads it)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def unflatten(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = list(v) if v.dtype == object else v
    return tree


def save_state(path: str, state, extra: dict):
    o = state.occ
    arrays = {**flatten(state.params, "params/"),
              **flatten(state.ema_params, "ema/"),
              "occ/density": np.asarray(o.density),
              "occ/occ": np.asarray(o.occ),
              "occ/mean_density": np.asarray(o.mean_density),
              "occ/iter_density": np.asarray(o.iter_density),
              "step": np.asarray(state.step), **extra}
    np.savez(path, **arrays)


def state_file(arm: str, seed: int) -> str:
    """The npz of a trained arm: bench.py's seed 7 as <arm>.npz, another
    seed as <arm>_seed<seed>.npz."""
    return f"{arm}.npz" if seed == SEED else f"{arm}_seed{seed}.npz"


def psnr_of(img, gt) -> float:
    from nerf_texture_tpu.utils.metrics import psnr
    return float(psnr(np.asarray(img), gt))


# -- stage jax ----------------------------------------------------------------

def jax_ngp() -> dict:
    from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu.models.ngp import NGPConfig
    from nerf_texture_tpu.render.renderer import RenderConfig
    from nerf_texture_tpu.train.trainer import TrainConfig, Trainer

    ds = SyntheticSphereDataset(n_frames=8, H=HW, W=HW)
    tr = Trainer(ds, NGPConfig(**NGP), RenderConfig(**NGP_RENDER),
                 TrainConfig(**NGP_TRAIN), key=jax.random.PRNGKey(SEED))
    t0 = time.perf_counter()
    losses = []
    for n in NGP_STEPS:
        losses.append(tr.train(n)["loss"])
    train_s = time.perf_counter() - t0
    pose = novel_pose()
    cells = {"view0": float(tr.eval_psnr([0], use_ema=False)),
             "novel": psnr_of(tr.render_frame(pose, use_ema=False)["image"],
                              white_gt(pose, ds.intrinsics, HW, HW))}
    save_state(os.path.join(OUT, "ngp.npz"), tr.state,
               {"losses": np.asarray(losses)})
    return {"arm": "ngp", "steps": int(tr.state.step), "cells": cells,
            "loss_after_each_call": losses,
            "cpu_s_not_a_result": round(train_s, 1)}


def jax_curved(seed: int = SEED) -> dict:
    from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu.geometry.mesh import make_icosphere
    from nerf_texture_tpu.geometry.projector import MeshProjector
    from nerf_texture_tpu.models import mesh_field
    from nerf_texture_tpu.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu.render.renderer import RenderConfig
    from nerf_texture_tpu.train.curved_trainer import (CurvedTrainConfig,
                                                       CurvedTrainer)

    ds = SyntheticSphereDataset(n_frames=8, H=HW, W=HW)
    mp = MeshProjector(make_icosphere(4, radius=0.5))
    rcfg = RenderConfig(**CURVED_RENDER)
    tr = CurvedTrainer(ds, mesh_field.make_state(mp),
                       CurvedFieldConfig(field=MeshFieldConfig(),
                                         light_model="SH"),
                       rcfg, CurvedTrainConfig(**CURVED_TRAIN),
                       key=jax.random.PRNGKey(seed))
    t0 = time.perf_counter()
    tr.initialize_states(1)
    losses = []
    for n in CURVED_STEPS:
        losses.append(tr.train(n)["loss"])
        print(f"curved: step {int(tr.state.step)}, loss {losses[-1]:.5f}, "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
    train_s = time.perf_counter() - t0
    pose = novel_pose()
    gt = white_gt(pose, ds.intrinsics, HW, HW)
    cells = {"live": psnr_of(tr.render_frame(pose, use_ema=False)["image"],
                             gt),
             "pool": psnr_of(tr.render_frame(pose, use_ema=False,
                                             parity=True)["image"], gt),
             "ema_parity": psnr_of(tr.render_frame(pose, use_ema=True,
                                                   parity=True)["image"], gt)}
    tr.rcfg = dataclasses.replace(rcfg, **BAKED)
    cells["live_k16"] = psnr_of(tr.render_frame(pose, use_ema=False)["image"],
                                gt)
    tr.bake_atlas()
    cells["baked"] = psnr_of(tr.render_frame(pose, use_ema=False,
                                             baked=True)["image"], gt)
    tr.rcfg = dataclasses.replace(tr.rcfg, **BAKED_CAP6)
    cells["baked_cap6"] = psnr_of(tr.render_frame(pose, use_ema=False,
                                                  baked=True)["image"], gt)
    save_state(os.path.join(OUT, state_file("curved", seed)), tr.state,
               {"losses": np.asarray(losses),
                "anchor_table": np.asarray(tr._anchor_table())})
    return {"arm": "curved", "seed": seed, "steps": int(tr.state.step),
            "cells": cells,
            "pool_minus_baked_k16": cells["pool"] - cells["baked"],
            "pool_minus_live_k16": cells["pool"] - cells["live_k16"],
            "loss_after_each_call": losses,
            "cpu_s_not_a_result": round(train_s, 1)}


# -- stage port ---------------------------------------------------------------

def frame_match(name: str, jout, tout) -> dict:
    """One port frame against the JAX package's: PSNR, max abs difference
    and the share of pixels whose liveness (weights_sum > 0) differs,
    each beside PR 3's bound."""
    a = np.asarray(jout["image"], np.float64)
    b = tout["image"].numpy().astype(np.float64)
    mse = float(np.mean((a - b) ** 2))
    live_j = np.asarray(jout["weights_sum"]) > 0
    live_t = tout["weights_sum"].numpy() > 0
    res = {"frame": name, "psnr": (10 * np.log10(1.0 / mse) if mse > 0
                                   else float("inf")),
           "max_abs": float(np.abs(a - b).max()),
           "live_share": float(live_j.mean()),
           "live_off": float(np.mean(live_j != live_t))}
    res["ok"] = bool(res["psnr"] >= FRAME_PSNR_MIN
                     and res["max_abs"] <= FRAME_MAX_ABS
                     and res["live_off"] <= LIVE_OFF_MAX)
    return res


def port_ngp(hw: int) -> dict:
    import torch

    from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu.models.ngp import NGPConfig
    from nerf_texture_tpu.ops.occupancy import OccupancyGrid
    from nerf_texture_tpu.render.renderer import RenderConfig
    from nerf_texture_tpu.train.trainer import TrainConfig, Trainer
    from nerf_texture_tpu_torch.convert import (occupancy_from_jax,
                                                params_from_jax)
    from nerf_texture_tpu_torch.data import synthetic as tsyn
    from nerf_texture_tpu_torch.models import ngp as tngp
    from nerf_texture_tpu_torch.render import renderer as trr
    from nerf_texture_tpu_torch.train import trainer as ttr

    flat = dict(np.load(os.path.join(OUT, "ngp.npz"), allow_pickle=True))
    params = unflatten(flat, "params/")
    ds = SyntheticSphereDataset(n_frames=8, H=hw, W=hw)
    tj = Trainer(ds, NGPConfig(**NGP), RenderConfig(**NGP_RENDER),
                 TrainConfig(**NGP_TRAIN), key=jax.random.PRNGKey(SEED))
    occ = OccupancyGrid(density=jax.numpy.asarray(flat["occ/density"]),
                        occ=jax.numpy.asarray(flat["occ/occ"]),
                        mean_density=jax.numpy.asarray(
                            flat["occ/mean_density"]),
                        iter_density=jax.numpy.asarray(
                            flat["occ/iter_density"]))
    tj.state = tj.state._replace(params=jax.tree.map(jax.numpy.asarray,
                                                     params), occ=occ)
    tt = ttr.Trainer(tsyn.SyntheticSphereDataset(n_frames=8, H=hw, W=hw),
                     tngp.NGPConfig(**NGP), trr.RenderConfig(**NGP_RENDER),
                     ttr.TrainConfig(**NGP_TRAIN), seed=SEED, device="cpu")
    tt.state.params = params_from_jax(params, device="cpu")
    tt.state.occ = occupancy_from_jax(
        flat["occ/density"], flat["occ/occ"], flat["occ/mean_density"],
        int(flat["occ/iter_density"]), device="cpu")
    pose = novel_pose()
    gt = white_gt(pose, ds.intrinsics, hw, hw)
    t0 = time.perf_counter()
    jo = tj.render_frame(pose, use_ema=False)
    with torch.no_grad():
        to = tt.render_frame(pose, use_ema=False)
    m = frame_match("novel", jo, to)
    m.update(jax_psnr=psnr_of(jo["image"], gt),
             port_psnr=psnr_of(to["image"].numpy(), gt))
    return {"arm": "ngp", "hw": hw, "frames": [m],
            "cpu_s": round(time.perf_counter() - t0, 1)}


def port_curved(hw: int) -> dict:
    import torch

    from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu.geometry.mesh import make_icosphere as jico
    from nerf_texture_tpu.geometry.projector import MeshProjector as JMP
    from nerf_texture_tpu.models import curved_field as jcf
    from nerf_texture_tpu.models import mesh_field as jmf
    from nerf_texture_tpu.ops.occupancy import OccupancyGrid
    from nerf_texture_tpu.render import renderer as jr
    from nerf_texture_tpu.train import curved_trainer as jct
    from nerf_texture_tpu_torch.convert import (occupancy_from_jax,
                                                params_from_jax)
    from nerf_texture_tpu_torch.data import synthetic as tsyn
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import curved_field as tcf
    from nerf_texture_tpu_torch.models import mesh_field as tmf
    from nerf_texture_tpu_torch.render import renderer as trr
    from nerf_texture_tpu_torch.train import curved_trainer as tct

    flat = dict(np.load(os.path.join(OUT, "curved.npz"),
                       allow_pickle=True))
    params, ema = unflatten(flat, "params/"), unflatten(flat, "ema/")
    ds = SyntheticSphereDataset(n_frames=8, H=hw, W=hw)
    rj = jr.RenderConfig(**CURVED_RENDER)
    tj = jct.CurvedTrainer(ds, jmf.make_state(JMP(jico(4, radius=0.5))),
                           jcf.CurvedFieldConfig(
                               field=jmf.MeshFieldConfig(),
                               light_model="SH"),
                           rj, jct.CurvedTrainConfig(**CURVED_TRAIN),
                           key=jax.random.PRNGKey(SEED))
    occ = OccupancyGrid(density=jax.numpy.asarray(flat["occ/density"]),
                        occ=jax.numpy.asarray(flat["occ/occ"]),
                        mean_density=jax.numpy.asarray(
                            flat["occ/mean_density"]),
                        iter_density=jax.numpy.asarray(
                            flat["occ/iter_density"]))
    tj.state = tj.state._replace(
        params=jax.tree.map(jax.numpy.asarray, params),
        ema_params=jax.tree.map(jax.numpy.asarray, ema), occ=occ)
    tab = flat["anchor_table"]
    st = tmf.make_state(MeshProjector(make_icosphere(4, radius=0.5),
                                      device="cpu"))
    rt = trr.RenderConfig(**CURVED_RENDER)
    ct = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(),
                               light_model="SH")
    tt = tct.CurvedTrainer(tsyn.SyntheticSphereDataset(n_frames=8, H=hw,
                                                        W=hw),
                           st, ct, rt, tct.CurvedTrainConfig(**CURVED_TRAIN),
                           seed=SEED, device="cpu")
    tt.state = tct.init_curved_state(
        tt.generator, ct, rt, tt.tcfg,
        params=params_from_jax(params, device="cpu"))
    tt.state.ema_params = params_from_jax(ema, device="cpu")
    tt.state.occ = occupancy_from_jax(
        flat["occ/density"], flat["occ/occ"], flat["occ/mean_density"],
        int(flat["occ/iter_density"]), device="cpu")
    tt._anchor_tab = (st.projector, True, torch.from_numpy(tab))
    pose = novel_pose()
    gt = white_gt(pose, ds.intrinsics, hw, hw)
    frames = []
    t0 = time.perf_counter()

    def both(name, **kw):
        jo = tj.render_frame(pose, **kw)
        with torch.no_grad():
            to = tt.render_frame(pose, **kw)
        m = frame_match(name, jo, to)
        m.update(jax_psnr=psnr_of(jo["image"], gt),
                 port_psnr=psnr_of(to["image"].numpy(), gt))
        frames.append(m)
        print(json.dumps(m), flush=True)

    both("live", use_ema=False)
    both("pool", use_ema=False, parity=True)
    both("ema_parity", use_ema=True, parity=True)
    for t in (tj, tt):
        t.rcfg = dataclasses.replace(t.rcfg, **BAKED)
    both("live_k16", use_ema=False)
    tj.bake_atlas()
    with torch.no_grad():
        tt.bake_atlas()
    both("baked", use_ema=False, baked=True)
    for t in (tj, tt):
        t.rcfg = dataclasses.replace(t.rcfg, **BAKED_CAP6)
    both("baked_cap6", use_ema=False, baked=True)
    return {"arm": "curved", "hw": hw, "frames": frames,
            "cpu_s": round(time.perf_counter() - t0, 1)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", choices=["jax", "port"], required=True)
    ap.add_argument("--arm", choices=["ngp", "curved", "both"],
                    default="both")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="the curved arm's PRNGKey (bench.py's: 7)")
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    arms = ["curved", "ngp"] if args.arm == "both" else [args.arm]
    for arm in arms:
        if args.stage == "jax":
            row = jax_ngp() if arm == "ngp" else jax_curved(args.seed)
        else:
            import torch
            torch.set_num_threads(4)
            row = (port_ngp if arm == "ngp" else port_curved)(FRAME_HW)
        print(json.dumps(row), flush=True)
        with open(os.path.join(OUT, f"{args.stage}.jsonl"), "a") as fh:
            fh.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
