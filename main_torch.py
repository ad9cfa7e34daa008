"""NeRF-Texture training with the PyTorch port (the counterpart of
main.py, with its flags and workspace layout, plus --device).

Pipeline:
  1. the coarse NGP mesh (``main_nerf_torch.py --save_mesh``) -> the
     template mesh (CoACD and manifold union where their binaries are
     installed, else the largest component; laplacian smoothing; remesh);
  2. h_threshold from the scan point cloud (2 x 70th percentile |sdf|),
     where ``W/meshes/pcl.ply`` exists;
  3. curved-field training with the scene's preset (camera optimisation
     on for a captured scene), ``--distillation`` from the NGP checkpoint,
     any ``--light_model`` (SH, SG, Envmap, None) and ``--encoder``
     (hash; vertex, with progressive levels every ``--iters_per_level``
     steps).

Usage:
  python3 main_torch.py data/star_flower --workspace logs/star_flower
  python3 main_torch.py <scene> --workspace W --distillation
  python3 main_torch.py synthetic_sphere --iters 2000
  python3 main_torch.py <scene> --light_model SG
  python3 main_torch.py <scene> --encoder vertex --iters_per_level 1000
  python3 main_torch.py <scene> --device cpu   # tiny scenes only
  python3 main_torch.py <scene> --workspace W --gui --port 7860

Trains on the card by default and raises where there is none.  With
``--gui`` it loads the checkpoint, then serves the viewer on ``--port``
(training, with the MJPEG stream and JSON control of
``nerf_texture_tpu_torch.viewer``) instead of the training loop.
Writes
``W/meshes/surface_coacd_remesh.obj``, ``W/checkpoints/<field_name>``
after every eval (loaded at start with ``--ckpt latest``) and
``W/log_curved.jsonl``.  Prints ``template: ... h_threshold=...``,
``[done/iters] loss=... PSNR=...`` and the seconds of its stages.
"""

import argparse
import dataclasses
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("scene", help="preset name or scene dir")
    p.add_argument("--workspace", default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--num_rays", type=int, default=None)
    p.add_argument("--light_model", default=None,
                   choices=["SH", "SG", "Envmap", "None"])
    p.add_argument("--encoder", default=None, choices=["hash", "vertex"],
                   help="feature storage (reference --hash flag)")
    p.add_argument("--iters_per_level", type=int, default=None,
                   help="progressive vertex-level cadence (0 = off)")
    p.add_argument("--distillation", action="store_true",
                   help="mix in sigma/color distillation steps from the "
                   "coarse NGP checkpoint in the workspace")
    p.add_argument("--gui", action="store_true")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--ckpt", default="latest")
    p.add_argument("--eval_interval", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default the card; 'cpu' runs the "
                   "kernels' plain versions)")
    return p.parse_args(argv)


def build_template_mesh(cfg, workspace):
    """The template: the saved one, else the NGP mesh through optional
    CoACD + manifold (else its largest component), smoothing and
    remeshing; the synthetic sphere's is an icosphere."""
    from nerf_texture_tpu_torch.geometry import shape_tools
    from nerf_texture_tpu_torch.geometry.mesh import (load_obj,
                                                      make_icosphere,
                                                      save_obj)

    template_path = os.path.join(workspace, "meshes",
                                 "surface_coacd_remesh.obj")
    if os.path.exists(template_path):
        return load_obj(template_path)

    ngp_mesh_path = os.path.join(workspace, "meshes", "ngp_mesh.obj")
    if not os.path.exists(ngp_mesh_path):
        if cfg.name == "synthetic_sphere":
            mesh = make_icosphere(3, radius=0.5)
            os.makedirs(os.path.dirname(template_path), exist_ok=True)
            save_obj(template_path, mesh)
            return mesh
        raise FileNotFoundError(
            f"{ngp_mesh_path} missing - run main_nerf_torch.py --save_mesh "
            "first")

    mesh = load_obj(ngp_mesh_path)
    decomposed = shape_tools.coacd(ngp_mesh_path,
                                   threshold=cfg.coacd_threshold)
    if decomposed != ngp_mesh_path:
        mesh = load_obj(shape_tools.manifold_union(
            decomposed, os.path.dirname(template_path)))
    else:
        # no CoACD/manifold binaries: at least shed the floating blobs
        # their union stage would have removed
        mesh = shape_tools.keep_largest_component(mesh)
    mesh = shape_tools.laplacian_smooth(mesh, iterations=8)
    mesh = shape_tools.remesh_isotropic(mesh)
    os.makedirs(os.path.dirname(template_path), exist_ok=True)
    save_obj(template_path, mesh)
    return mesh


def compute_h_threshold(workspace, template_projector, default=0.1):
    """2 x 70th-percentile |sdf(scan point cloud, template)|, or
    ``default`` without ``meshes/pcl.ply``."""
    import torch

    from nerf_texture_tpu_torch.geometry import projector as proj
    from nerf_texture_tpu_torch.geometry.mesh import load_ply_points

    pcl_path = os.path.join(workspace, "meshes", "pcl.ply")
    if not os.path.exists(pcl_path):
        return default
    pts = load_ply_points(pcl_path)
    if len(pts) > 20000:
        pts = pts[np.random.default_rng(0).choice(len(pts), 20000,
                                                  replace=False)]
    sdf, _, _, _ = proj.signed_distance(
        template_projector.arrays,
        torch.as_tensor(pts, dtype=torch.float32,
                        device=template_projector.device))
    return float(2.0 * np.percentile(np.abs(sdf.cpu().numpy()), 70))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from nerf_texture_tpu_torch.parallel import initialize_multihost

    # a torchrun launch (MASTER_ADDR etc. set): each process joins the
    # process group and trains on its own card (cuda:LOCAL_RANK); without
    # one, a no-op
    initialize_multihost(backend="nccl" if torch.device(args.device).type
                         == "cuda" else "gloo")
    from nerf_texture_tpu_torch.config import get_preset
    from nerf_texture_tpu_torch.data.provider import NeRFDataset
    from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.ngp import NGPConfig
    from nerf_texture_tpu_torch.ops.proxy_select import (proxy_select,
                                                         proxy_select_cdf)
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainer, load_ngp_teacher)

    device = torch.empty(0, device=args.device).device  # raises without it
    overrides = {}
    if args.iters is not None:
        overrides["iters"] = args.iters
    if args.num_rays is not None:
        overrides["num_rays"] = args.num_rays
    if args.light_model is not None:
        overrides["light_model"] = args.light_model
    if args.encoder is not None:
        overrides["encoder_type"] = args.encoder
    if args.iters_per_level is not None:
        overrides["iters_per_level"] = args.iters_per_level
    cfg = get_preset(args.scene, **overrides)
    workspace = args.workspace or cfg.workspace
    os.makedirs(workspace, exist_ok=True)

    t0 = time.perf_counter()
    if cfg.name == "synthetic_sphere":
        dataset = SyntheticSphereDataset(n_frames=24, H=400, W=400)
    else:
        dataset = NeRFDataset(cfg.path, mode=cfg.mode, split="train",
                              downscale=cfg.downscale, scale=cfg.scale)
    load_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    template = build_template_mesh(cfg, workspace)
    template_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    projector = MeshProjector(template, device=device)
    projector_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    h_thr = compute_h_threshold(workspace, projector,
                                default=cfg.h_threshold)
    h_s = time.perf_counter() - t0
    print(f"template: {len(template.vertices)} verts, "
          f"h_threshold={h_thr:.4f}")
    cfg = dataclasses.replace(cfg, h_threshold=h_thr)
    if cfg.encoder_type == "vertex":
        # the vertex encoder's level-0 feature mesh fixes the feature
        # count; the progressive levels grow it (update_field_level)
        t0 = time.perf_counter()
        fea = mesh_field.make_feature_projector(
            template, min_vertices=mesh_field.levels_vnum(cfg.field)[0],
            device=device)
        nv0 = int(fea.arrays.vertices.shape[0])
        ccfg = dataclasses.replace(cfg.curved, field=dataclasses.replace(
            cfg.field, n_feature_vertices=nv0))
        field_state = mesh_field.make_state(projector, fea_projector=fea)
        print(f"feature mesh: {nv0} vertices in "
              f"{time.perf_counter() - t0:.3f} s; levels "
              f"{mesh_field.levels_vnum(cfg.field)}")
    else:
        ccfg = cfg.curved
        field_state = mesh_field.make_state(projector)

    curved_tcfg = cfg.curved_train
    teacher = None
    if args.distillation:
        curved_tcfg = dataclasses.replace(curved_tcfg, distillation=True)
        teacher = load_ngp_teacher(workspace,
                                   NGPConfig(bound=cfg.render.bound),
                                   device=device)
    trainer = CurvedTrainer(dataset, field_state, ccfg, cfg.render,
                            curved_tcfg,
                            seed=args.seed, device=device, teacher=teacher,
                            workspace=workspace)
    trainer.template_mesh = template
    t0 = time.perf_counter()
    near = trainer._get_near_cells()
    near_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer._refresh_anchor_tab()
    _sync(device)
    table_s = time.perf_counter() - t0
    print(f"setup: scene load {load_s:.3f} s ({dataset.num_frames} frames "
          f"{dataset.H}x{dataset.W}); template pipeline {template_s:.3f} s; "
          f"projector {projector_s:.3f} s; h_threshold {h_s:.3f} s; near "
          f"cells {near_s:.3f} s ({near.shape[0]}); anchor table "
          f"{table_s:.3f} s; teacher {'on' if teacher else 'off'}")

    ckpt_dir = os.path.join(workspace, "checkpoints", cfg.field_name)
    if args.ckpt == "latest" and os.path.exists(ckpt_dir):
        print("loading checkpoint", ckpt_dir)
        t0 = time.perf_counter()
        trainer.load_checkpoint(ckpt_dir)
        _sync(device)
        print(f"checkpoint: loaded step {trainer.state.step} in "
              f"{time.perf_counter() - t0:.3f} s")

    if args.gui:
        from nerf_texture_tpu_torch.viewer import ViewerApp, serve

        app = ViewerApp(trainer, W=dataset.W, H=dataset.H)
        app.training = True
        serve(app, port=args.port)
        return

    done = trainer.state.step
    while done < cfg.iters:
        n = min(args.eval_interval, cfg.iters - done)
        t0 = time.perf_counter()
        m = trainer.train(n, log_every=500)
        train_s = time.perf_counter() - t0
        done += n
        t0 = time.perf_counter()
        before = (proxy_select.launches, proxy_select_cdf.launches)
        psnr = trainer.eval_psnr([0])
        eval_ms = (time.perf_counter() - t0) * 1e3
        launches = (proxy_select.launches - before[0],
                    proxy_select_cdf.launches - before[1])
        print(f"[{done}/{cfg.iters}] loss={m['loss']:.5f} "
              f"PSNR={psnr:.2f}")
        print(f"timing: {n} steps in {train_s:.2f} s = {n / train_s:.2f} "
              f"it/s; eval frame {eval_ms:.1f} ms; selection launches: "
              f"proxy_select {launches[0]}, proxy_select_cdf "
              f"{launches[1]}")
        if trainer.logger is not None:
            trainer.logger.log(done, psnr=psnr)
        t0 = time.perf_counter()
        trainer.save_checkpoint(ckpt_dir)
        size = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                   for f in os.listdir(ckpt_dir))
        print(f"checkpoint: saved step {done} in "
              f"{time.perf_counter() - t0:.3f} s, {size / 2 ** 20:.2f} MiB")


if __name__ == "__main__":
    main()
