"""The JAX package's seven-stage parity pipeline on the textured shell,
for several seeds: the reference side of the port's
``scripts/torch_shell_pipeline.py`` comparison (ROADMAP Queue 3 item 1).

The stages, configs, gates and held-out pose are those of
``tests/test_parity_pipeline.py::_run_pipeline``; the only change is that
the two PRNG keys are arguments: seed ``s`` trains the NGP from
``PRNGKey(3 + s)`` and the curved field from ``PRNGKey(4 + s)``, so seed
0 is the test's own run.  The scene, the h_threshold draw and the
quilting seed stay fixed.  A gate that fails is recorded, not raised, so
that every seed gives its PSNRs; the stages after a failed mesh gate
still run where they can.

One JSON line a seed (and the same to ``--out``, one object a line):
ngp_psnr, curved_psnr, h, patches, vertices, median radius, the
imported canvas's weights_sum max, lit pixels (weights_sum > 0.1) and
their std, each stage's seconds, the failed gates.

    JAX_PLATFORMS=cpu python scripts/shell_pipeline_jax.py --profile FULL \\
        --seeds 0 1 2 --out build/shell_jax.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nerf_texture_tpu.data.poses import orbit_pose  # noqa: E402
from nerf_texture_tpu.data.synthetic import (  # noqa: E402
    SyntheticShellDataset, render_gt_shell)
from nerf_texture_tpu.models import ngp as ngp_mod  # noqa: E402
from nerf_texture_tpu.models.ngp import NGPConfig  # noqa: E402
from nerf_texture_tpu.render.renderer import RenderConfig  # noqa: E402
from nerf_texture_tpu.train.trainer import TrainConfig, Trainer  # noqa: E402
from nerf_texture_tpu.utils.metrics import psnr  # noqa: E402

# the profiles of tests/test_parity_pipeline.py
FAST = dict(H=28, frames=6, ngp_steps=200, curved_steps=120, mesh_res=40,
            ngp_gate=15.0, curved_gate=10.0, desired_res=96,
            hashmap=13, bricks=10, mc_threshold=5.0)
FULL = dict(H=40, frames=10, ngp_steps=600, curved_steps=500, mesh_res=64,
            ngp_gate=17.0, curved_gate=15.0, desired_res=256,
            hashmap=15, bricks=12, mc_threshold=10.0)
PROFILES = {"FAST": FAST, "FULL": FULL}


def _gt(pose, intr, ds, H, W):
    img = render_gt_shell(pose, intr, H, W, ds.base, ds.bump_amp)
    rgb = img[..., :3].astype(np.float32) / 255.0
    a = img[..., 3:].astype(np.float32) / 255.0
    return rgb * a + (1.0 - a)


def run(P: dict, seed: int, workdir: str) -> dict:
    res = {"seed": seed, "seconds": {}, "failed": []}
    t = [time.perf_counter()]

    def mark(stage):
        now = time.perf_counter()
        res["seconds"][stage] = now - t[0]
        t[0] = now

    def gate(name, ok):
        if not ok:
            res["failed"].append(name)

    H = W = P["H"]
    ds = SyntheticShellDataset(n_frames=P["frames"], H=H, W=W)
    holdout_pose = orbit_pose(np.pi / 2 + 0.25, 1.234, ds.radius)
    gt_holdout = _gt(holdout_pose, ds.intrinsics, ds, H, W)

    mcfg = NGPConfig(bound=1.0, num_levels=6, level_dim=2,
                     base_resolution=16,
                     desired_resolution=P["desired_res"],
                     log2_hashmap_size=P["hashmap"], hidden_dim=64,
                     hidden_dim_color=64)
    rcfg = RenderConfig(bound=1.0, cascades=1, grid_size=32, max_steps=96,
                        max_samples_train=48, max_samples_infer=64,
                        ray_chunk=1600, infer_mode="pool")
    tcfg = TrainConfig(lr=1e-2, total_steps=P["ngp_steps"], num_rays=512,
                       grid_update_interval=16, grid_decay=0.85)
    ngp_tr = Trainer(ds, mcfg, rcfg, tcfg, key=jax.random.PRNGKey(3 + seed))
    ngp_tr.train(P["ngp_steps"])
    out = ngp_tr.render_frame(holdout_pose, use_ema=False)
    res["ngp_psnr"] = psnr(out["image"], gt_holdout)
    mark("ngp")
    gate("ngp_psnr", res["ngp_psnr"] > P["ngp_gate"])

    from nerf_texture_tpu.geometry import shape_tools
    from nerf_texture_tpu.train import field_io

    params = ngp_tr.state.params

    def density(p):
        return ngp_mod.density(params, p, mcfg)[0]

    v, f = field_io.save_mesh(density, os.path.join(workdir, "ngp_mesh.obj"),
                              resolution=P["mesh_res"], bound=1.0,
                              threshold=P["mc_threshold"])
    res["vertices"] = int(len(v))
    gate("vertices", len(v) > 200)
    radii = np.linalg.norm(v, axis=-1)
    res["median_radius"] = float(np.median(radii)) if len(v) else None
    gate("median_radius", len(v) > 0
         and abs(res["median_radius"] - ds.base) < 0.1)
    mark("mesh")

    from nerf_texture_tpu.geometry import projector as proj
    from nerf_texture_tpu.geometry.mesh import Mesh
    from nerf_texture_tpu.geometry.projector import MeshProjector

    mesh_raw = shape_tools.keep_largest_component(
        Mesh(np.asarray(v, np.float32), np.asarray(f)))
    mesh = shape_tools.laplacian_smooth(mesh_raw, iterations=6)
    mp = MeshProjector(mesh)
    vr = mesh_raw.vertices
    pts = jnp.asarray(vr[np.random.default_rng(0).choice(
        len(vr), size=min(2000, len(vr)), replace=False)], jnp.float32)
    sdf = proj.signed_distance(mp.arrays, pts)[0]
    h_threshold = float(2.0 * jnp.quantile(jnp.abs(sdf), 0.7))
    h_threshold = max(h_threshold, 2.5 * ds.bump_amp)
    res["h"] = h_threshold
    gate("h", h_threshold < 0.35)
    mark("template")

    from nerf_texture_tpu.models import mesh_field
    from nerf_texture_tpu.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu.train.curved_trainer import (CurvedTrainConfig,
                                                       CurvedTrainer)

    fcfg = MeshFieldConfig(num_levels=4, level_dim=2, base_resolution=32,
                           desired_resolution=P["desired_res"],
                           log2_bricks=P["bricks"],
                           h_threshold=h_threshold, clustering=False)
    ccfg = CurvedFieldConfig(field=fcfg, light_model="SH",
                             hidden_dim=32, geo_feat_dim=15)
    crcfg = dataclasses.replace(rcfg, ray_chunk=1600)
    ctcfg = CurvedTrainConfig(lr=1e-2, total_steps=P["curved_steps"],
                              num_rays=512, grid_update_interval=16,
                              grid_full_updates=2)
    ctr = CurvedTrainer(ds, mesh_field.make_state(mp), ccfg, crcfg,
                        ctcfg, key=jax.random.PRNGKey(4 + seed))
    ctr.initialize_states(1)
    ctr.train(P["curved_steps"])
    out = ctr.render_frame(holdout_pose, use_ema=False)
    res["curved_psnr"] = psnr(out["image"], gt_holdout)
    mark("curved")
    gate("curved_psnr", res["curved_psnr"] > P["curved_gate"])

    from nerf_texture_tpu.synthesis.patches import PatchSampleConfig
    from nerf_texture_tpu.synthesis.quilting import (QuiltingConfig,
                                                     QuiltingSynthesizer)

    scfg = PatchSampleConfig(patch_size=8, max_patch_num=8,
                             center_batch=4, pattern_rate=1 / 6)
    field_path = os.path.join(workdir, "field.npz")
    exported = field_io.save_field(ctr, field_path, mesh=mesh, scfg=scfg)
    res["patches"] = int(exported["patches"].shape[0])
    gate("patches", res["patches"] >= 4)
    res["patch_std"] = float(np.std(exported["patches"]))
    gate("patch_std", res["patch_std"] > 1e-3)
    mark("export")

    data = np.load(field_path, allow_pickle=True)
    patches = np.concatenate(
        [data["patches"], data["patch_phi_embed"],
         data["patch_local_tbn"].reshape(
             *data["patch_local_tbn"].shape[:3], 9)], -1)
    syn = QuiltingSynthesizer(
        patches, QuiltingConfig(output_size=(32, 32), seed=0),
        match_dim=data["patches"].shape[-1],
        sample_tbn=data["patch_sample_tbn"],
        picked_vertices=data["picked_vertices"],
        patch_length=float(data["grid_gap"]) * 8)
    syn.synthesize()
    tex = syn.export(grid_gap=float(data["grid_gap"]),
                     phi_embed_dim=data["patch_phi_embed"].shape[-1])
    tex_path = os.path.join(workdir, "texture.npz")
    np.savez(tex_path, **{k: x for k, x in tex.items() if x is not None})
    mark("quilt")

    field_io.load_field(ctr, tex_path)
    gate("mode_field", ctr.mode == "field")
    outimg = ctr.render_frame(ds.poses[0], use_ema=False)
    img = np.asarray(outimg["image"])
    gate("field_finite", bool(np.isfinite(img).all()))
    ws = np.asarray(outimg["weights_sum"]).reshape(-1)
    acc = ws > 0.1
    res["field_ws_max"] = float(ws.max())
    res["field_lit"] = int(acc.sum())
    gate("field_visible", bool(acc.any()))
    res["field_std"] = float(img.reshape(-1, 3)[acc].std()) \
        if acc.any() else 0.0
    gate("field_textured", res["field_std"] > 0.005)

    field_io.load_patch(ctr, field_path, patch_id=0)
    outimg = ctr.render_frame(ds.poses[0], use_ema=False)
    gate("patch_finite", bool(np.isfinite(np.asarray(outimg["image"])).all()))
    mark("reimport")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", choices=sorted(PROFILES), default="FULL")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--out", default=None,
                    help="append one JSON object a seed to this file")
    args = ap.parse_args()
    for s in args.seeds:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            res = run(PROFILES[args.profile], s, d)
        res.update(profile=args.profile, package="jax",
                   wall=time.perf_counter() - t0)
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(line + "\n")


if __name__ == "__main__":
    main()
