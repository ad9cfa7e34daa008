"""The seven-stage NeRF-Texture pipeline on the textured bumpy shell, in
the PyTorch port: coarse NGP -> ``save_mesh`` -> template (largest
component + Laplacian smoothing) + ``h_threshold`` -> curved-field
training -> patch export -> quilting -> re-import (``load_field``,
``load_patch``) and render.

Stage for stage the JAX package's ``tests/test_parity_pipeline.py::
_run_pipeline``: the same FAST / FULL profiles, configs, gates and
held-out pose; ``scripts/shell_pipeline_jax.py`` runs the JAX side with
the same seeds.  Seed ``s`` seeds the NGP trainer with 3 + s and the
curved trainer with 4 + s (the JAX keys' numbers); the scene, the
h_threshold draw and the quilting seed stay fixed.

``run(profile, seed, device)`` returns the NGP and curved PSNRs, ``h``,
the patch count, each stage's seconds and the gates that failed (an
empty list when every gate of the profile held).  On the card it also
renders the trained NGP, the trained curved field and the re-imported
``field`` canvas through the proxy path at 10x the scene's size (400x400
on FULL; ray chunk 16384, block 8), each once through the inverse-CDF
selection kernel and once through the top-k one, and holds each kernel
frame against its plain-selection frame.  The stages are functions of
their own (``ngp_stage`` ... ``patch_stage``), which
``scripts/torch_shell_replay.py`` also runs.  Imports only the port.

    python3 scripts/torch_shell_pipeline.py --profile FULL --seeds 0 1 2
    python3 scripts/torch_shell_pipeline.py --profile FAST --device cpu
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nerf_texture_tpu_torch.data.poses import orbit_pose  # noqa: E402
from nerf_texture_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticShellDataset, render_gt_shell)
from nerf_texture_tpu_torch.models import ngp as ngp_mod  # noqa: E402
from nerf_texture_tpu_torch.ops import proxy_select as ps  # noqa: E402
from nerf_texture_tpu_torch.render.renderer import RenderConfig  # noqa: E402
from nerf_texture_tpu_torch.train.trainer import (  # noqa: E402
    TrainConfig, Trainer, ngp_infer_params, render_frame)
from nerf_texture_tpu_torch.utils.metrics import psnr  # noqa: E402

# knobs per tier, as tests/test_parity_pipeline.py's: frames of H x H,
# training steps, the mesh's resolution and density threshold, the
# encoders' finest resolution and table sizes, and the PSNR gates
FAST = dict(H=28, frames=6, ngp_steps=200, curved_steps=120, mesh_res=40,
            ngp_gate=15.0, curved_gate=10.0, desired_res=96,
            hashmap=13, bricks=10, mc_threshold=5.0)
FULL = dict(H=40, frames=10, ngp_steps=600, curved_steps=500, mesh_res=64,
            ngp_gate=17.0, curved_gate=15.0, desired_res=256,
            hashmap=15, bricks=12, mc_threshold=10.0)
PROFILES = {"FAST": FAST, "FULL": FULL}

# the kernel frames: the scene's intrinsics scaled by this, the bench's
# ray chunk, block prepass (block 8, tau_cull 0.1) and one selection
# round; CDF at the bench caps (NGP 4, curved 5), top-k at cap 8
KERNEL_SCALE = 10
KERNEL_RENDER = dict(infer_mode="proxy", ray_chunk=16384, proxy_samples=0,
                     prepass_block=8, prepass_tau_cull=0.1)
SELECTIONS = (("cdf", dict(infer_cdf=True)),
              ("topk", dict(infer_cdf=False, infer_color_cap=8)))


def ngp_configs(P: dict) -> tuple[dict, dict, dict]:
    """Stage 1's NGPConfig, RenderConfig and TrainConfig keywords (the
    JAX package's tests/test_parity_pipeline.py:90-100)."""
    return (dict(bound=1.0, num_levels=6, level_dim=2, base_resolution=16,
                 desired_resolution=P["desired_res"],
                 log2_hashmap_size=P["hashmap"], hidden_dim=64,
                 hidden_dim_color=64),
            dict(bound=1.0, cascades=1, grid_size=32, max_steps=96,
                 max_samples_train=48, max_samples_infer=64, ray_chunk=1600,
                 infer_mode="pool"),
            dict(lr=1e-2, total_steps=P["ngp_steps"], num_rays=512,
                 grid_update_interval=16, grid_decay=0.85))


def curved_configs(P: dict, h: float) -> tuple[dict, dict, dict]:
    """Stage 4's MeshFieldConfig, CurvedFieldConfig (but the field) and
    CurvedTrainConfig keywords (tests/test_parity_pipeline.py:158-169);
    its RenderConfig is stage 1's."""
    return (dict(num_levels=4, level_dim=2, base_resolution=32,
                 desired_resolution=P["desired_res"],
                 log2_bricks=P["bricks"], h_threshold=h, clustering=False),
            dict(light_model="SH", hidden_dim=32, geo_feat_dim=15),
            dict(lr=1e-2, total_steps=P["curved_steps"], num_rays=512,
                 grid_update_interval=16, grid_full_updates=2))


def holdout_gt(ds, pose) -> np.ndarray:
    """The shell's ground truth at ``pose`` over white, [H, W, 3] f32."""
    img = render_gt_shell(pose, ds.intrinsics, ds.H, ds.W, ds.base,
                          ds.bump_amp)
    rgb = img[..., :3].astype(np.float32) / 255.0
    a = img[..., 3:].astype(np.float32) / 255.0
    return rgb * a + (1.0 - a)


def h_threshold(mesh_raw, mp, bump_amp: float) -> float:
    """The shell's half-thickness: 2 x the 70th percentile of |sdf| to the
    template of 2,000 raw-mesh vertices (``np.random.default_rng(0)``),
    at least 2.5 bump amplitudes (the reference's main.py:143-154)."""
    from nerf_texture_tpu_torch.geometry.projector import signed_distance

    vr = mesh_raw.vertices
    pts = vr[np.random.default_rng(0).choice(
        len(vr), size=min(2000, len(vr)), replace=False)]
    pts = torch.as_tensor(np.asarray(pts, np.float32), device=mp.device)
    sdf = signed_distance(mp.arrays, pts)[0]
    h = float(2.0 * torch.quantile(torch.abs(sdf), 0.7))
    return max(h, 2.5 * bump_amp)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _kernel_rcfg(rcfg: RenderConfig, cap: int, sel: dict) -> RenderConfig:
    return dataclasses.replace(rcfg, **{**KERNEL_RENDER,
                                        "infer_color_cap": cap, **sel})


def _kernel_frame(render, device) -> dict:
    """One kernel frame (``render(plain)`` -> render_image's dict) and its
    plain-selection frame: the selection launches of the kernel frame,
    its chunks and live rays, ms, and whether the two frames are equal
    bit for bit (each of image, depth and weights_sum)."""
    n0 = (ps.proxy_select_cdf.launches, ps.proxy_select.launches)
    _sync(device)
    t0 = time.perf_counter()
    out = render(False)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"cdf": ps.proxy_select_cdf.launches - n0[0],
                "topk": ps.proxy_select.launches - n0[1]}
    plain = render(True)
    bitwise = all(torch.equal(out[k], plain[k])
                  for k in ("image", "depth", "weights_sum"))
    return {"ms": ms, "live": int(out["live"]), "chunks": int(out["chunks"]),
            "launches": launches, "bitwise": bool(bitwise),
            "lit": float((out["weights_sum"] > 0.1).float().mean())}


def _ngp_kernel_frames(tr, pose, device) -> dict:
    ds = tr.dataset
    H, W = ds.H * KERNEL_SCALE, ds.W * KERNEL_SCALE
    intr = ds.intrinsics * KERNEL_SCALE
    params = ngp_infer_params(tr.state.params, tr.mcfg)
    out = {}
    for name, sel in SELECTIONS:
        rc = _kernel_rcfg(tr.rcfg, 4, sel)
        out[name] = _kernel_frame(
            lambda plain, rc=rc: render_frame(
                params, tr.state.occ, pose, intr, H, W, tr.mcfg, rc,
                plain_select=plain), device)
    return out


def _curved_kernel_frames(tr, pose, device) -> dict:
    """The curved trainer's live frame at 10x (its dataset's intrinsics
    scaled on a shallow copy for the frame's duration)."""
    ds, rcfg = tr.dataset, tr.rcfg
    big = copy.copy(ds)
    big.intrinsics = ds.intrinsics * KERNEL_SCALE
    H, W = ds.H * KERNEL_SCALE, ds.W * KERNEL_SCALE
    out = {}
    try:
        tr.dataset = big
        for name, sel in SELECTIONS:
            tr.rcfg = _kernel_rcfg(rcfg, 5, sel)
            out[name] = _kernel_frame(
                lambda plain: tr.render_frame(pose, use_ema=False, H=H, W=W,
                                              plain_select=plain), device)
    finally:
        tr.dataset, tr.rcfg = ds, rcfg
    return out


class StageLog:
    """A run's result dict: each stage's seconds (``mark``) and the gates
    that failed (``gate``)."""

    def __init__(self, device, **res):
        self.device = device
        self.res = {**res, "seconds": {}, "failed": []}
        self.t = time.perf_counter()

    def mark(self, stage: str):
        _sync(self.device)
        now = time.perf_counter()
        self.res["seconds"][stage] = now - self.t
        self.t = now

    def gate(self, name: str, ok: bool):
        if not ok:
            self.res["failed"].append(name)


def scene(P: dict):
    """(the shell dataset, the held-out pose, its ground truth)."""
    ds = SyntheticShellDataset(n_frames=P["frames"], H=P["H"], W=P["H"])
    pose = orbit_pose(np.pi / 2 + 0.25, 1.234, ds.radius)
    return ds, pose, holdout_gt(ds, pose)


def ngp_stage(P, ds, pose, gt, seed, device, log):
    """Stage 1: the coarse NGP, trained; its PSNR at the held-out pose.
    Returns (trainer, render config)."""
    mk, rk, tk = ngp_configs(P)
    mcfg = ngp_mod.NGPConfig(**mk)
    rcfg = RenderConfig(**rk)
    tcfg = TrainConfig(**tk)
    tr = Trainer(ds, mcfg, rcfg, tcfg, seed=3 + seed, device=device)
    tr.train(P["ngp_steps"])
    out = tr.render_frame(pose, use_ema=False)
    log.res["ngp_psnr"] = psnr(out["image"], gt)
    log.gate("ngp_psnr", log.res["ngp_psnr"] > P["ngp_gate"])
    log.mark("ngp")
    return tr, rcfg


def template_stage(P, ds, tr, workdir, device, log):
    """Stages 2-3: the mesh of the NGP's density, its largest component
    smoothed into the template, and h_threshold.  Returns the template
    and its projector."""
    from nerf_texture_tpu_torch.geometry import shape_tools
    from nerf_texture_tpu_torch.geometry.mesh import Mesh
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.train import field_io

    params, mcfg = tr.state.params, tr.mcfg

    @torch.no_grad()
    def density(p):
        return ngp_mod.density(params, p, mcfg)[0]

    v, f = field_io.save_mesh(density, os.path.join(workdir, "ngp_mesh.obj"),
                              resolution=P["mesh_res"], bound=1.0,
                              threshold=P["mc_threshold"], device=device)
    res = log.res
    res["vertices"] = int(len(v))
    log.gate("vertices", len(v) > 200)
    res["median_radius"] = float(np.median(np.linalg.norm(v, axis=-1))) \
        if len(v) else None
    log.gate("median_radius", len(v) > 0
             and abs(res["median_radius"] - ds.base) < 0.1)
    log.mark("mesh")
    mesh_raw = shape_tools.keep_largest_component(
        Mesh(np.asarray(v, np.float32), np.asarray(f)))
    mesh = shape_tools.laplacian_smooth(mesh_raw, iterations=6)
    mp = MeshProjector(mesh, device=device)
    res["h"] = h_threshold(mesh_raw, mp, ds.bump_amp)
    log.gate("h", res["h"] < 0.35)
    log.mark("template")
    return mesh, mp


def curved_trainer(P, ds, mp, h: float, rcfg, seed, device):
    """Stage 4's curved trainer on the template's projector ``mp``, its
    grid initialised, untrained."""
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)

    fk, ck, tk = curved_configs(P, h)
    ccfg = CurvedFieldConfig(field=MeshFieldConfig(**fk), **ck)
    ctcfg = CurvedTrainConfig(**tk)
    ctr = CurvedTrainer(ds, mesh_field.make_state(mp), ccfg, rcfg, ctcfg,
                        seed=4 + seed, device=device)
    ctr.initialize_states(1)
    return ctr


def curved_stage(P, ds, mp, rcfg, pose, gt, seed, device, log):
    """Stage 4: the curved field trained; its PSNR at the held-out pose.
    Returns the trainer."""
    ctr = curved_trainer(P, ds, mp, log.res["h"], rcfg, seed, device)
    ctr.train(P["curved_steps"])
    out = ctr.render_frame(pose, use_ema=False)
    log.res["curved_psnr"] = psnr(out["image"], gt)
    log.gate("curved_psnr", log.res["curved_psnr"] > P["curved_gate"])
    log.mark("curved")
    return ctr


def export_stage(ctr, mesh, workdir, log):
    """Stage 5: patch export (field.npz) and quilting (texture.npz).
    Returns the two files' paths."""
    from nerf_texture_tpu_torch.synthesis.patches import PatchSampleConfig
    from nerf_texture_tpu_torch.synthesis.quilting import (
        QuiltingConfig, QuiltingSynthesizer)
    from nerf_texture_tpu_torch.train import field_io

    scfg = PatchSampleConfig(patch_size=8, max_patch_num=8, center_batch=4,
                             pattern_rate=1 / 6)
    field_path = os.path.join(workdir, "field.npz")
    exported = field_io.save_field(ctr, field_path, mesh=mesh, scfg=scfg)
    res = log.res
    res["patches"] = int(exported["patches"].shape[0])
    log.gate("patches", res["patches"] >= 4)
    res["patch_std"] = float(np.std(exported["patches"]))
    log.gate("patch_std", res["patch_std"] > 1e-3)
    log.mark("export")

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
    log.mark("quilt")
    return field_path, tex_path


def import_stage(ctr, ds, tex_path, log) -> dict:
    """Stage 6: ``load_field`` and the canvas's frame at the first
    training pose, gated as textured (in-silhouette variance).  Returns
    the frame."""
    from nerf_texture_tpu_torch.train import field_io

    field_io.load_field(ctr, tex_path)
    log.gate("mode_field", ctr.mode == "field")
    out = ctr.render_frame(ds.poses[0], use_ema=False)
    img = out["image"].cpu().numpy()
    log.gate("field_finite", bool(np.isfinite(img).all()))
    ws = out["weights_sum"].cpu().numpy().reshape(-1)
    acc = ws > 0.1
    res = log.res
    res["field_ws_max"] = float(ws.max())
    res["field_lit"] = int(acc.sum())
    log.gate("field_visible", bool(acc.any()))
    res["field_std"] = float(img.reshape(-1, 3)[acc].std()) \
        if acc.any() else 0.0
    log.gate("field_textured", res["field_std"] > 0.005)
    log.mark("load_field")
    return out


def patch_stage(ctr, ds, field_path, log):
    """Stage 6's ``load_patch`` and its (finite) frame."""
    from nerf_texture_tpu_torch.train import field_io

    field_io.load_patch(ctr, field_path, patch_id=0)
    out = ctr.render_frame(ds.poses[0], use_ema=False)
    log.gate("patch_finite", bool(torch.isfinite(out["image"]).all()))
    log.mark("load_patch")


def run(profile: str = "FULL", seed: int = 0, device: str = "cuda", *,
        workdir: str | None = None) -> dict:
    """The pipeline on ``profile`` (FAST or FULL) with ``seed``; see the
    module docstring.  On a CUDA ``device`` it also renders the kernel
    frames."""
    if workdir is None:
        with tempfile.TemporaryDirectory() as d:
            return run(profile, seed, device, workdir=d)
    P = PROFILES[profile]
    kernel_frames = torch.device(device).type == "cuda"
    log = StageLog(device, profile=profile, seed=seed)
    res = log.res
    if kernel_frames:
        res["kernel_frames"] = {}
    ds, pose, gt = scene(P)
    log.mark("scene")
    tr, rcfg = ngp_stage(P, ds, pose, gt, seed, device, log)
    if kernel_frames:
        res["kernel_frames"]["ngp"] = _ngp_kernel_frames(tr, pose, device)
        log.mark("ngp_kernel_frames")
    mesh, mp = template_stage(P, ds, tr, workdir, device, log)
    del tr
    ctr = curved_stage(P, ds, mp, rcfg, pose, gt, seed, device, log)
    if kernel_frames:
        res["kernel_frames"]["curved"] = _curved_kernel_frames(ctr, pose,
                                                               device)
        log.mark("curved_kernel_frames")
    field_path, tex_path = export_stage(ctr, mesh, workdir, log)
    import_stage(ctr, ds, tex_path, log)
    if kernel_frames:
        res["kernel_frames"]["field"] = _curved_kernel_frames(
            ctr, ds.poses[0], device)
        log.mark("field_kernel_frames")
    patch_stage(ctr, ds, field_path, log)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", choices=sorted(PROFILES), default="FULL")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="append one JSON object a seed to this file")
    args = ap.parse_args()
    for s in args.seeds:
        t0 = time.perf_counter()
        res = run(args.profile, s, args.device)
        res.update(package="torch", wall=time.perf_counter() - t0)
        if torch.device(args.device).type == "cuda":
            res["device"] = torch.cuda.get_device_name(0)
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(line + "\n")


if __name__ == "__main__":
    main()
