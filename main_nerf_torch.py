"""Coarse Instant-NGP training with the PyTorch port (the counterpart of
main_nerf.py, with its flags and workspace layout, plus --device).

Usage:
  python3 main_nerf_torch.py data/star_flower --workspace logs/star_flower \
      --save_mesh
  python3 main_nerf_torch.py synthetic_sphere --iters 2000
  python3 main_nerf_torch.py <scene> --bound 2 --dt_gamma 0.0078125
  python3 main_nerf_torch.py <scene> --gui --port 7860
  python3 main_nerf_torch.py <scene> --device cpu   # tiny scenes only

Trains on the card by default and raises where there is none.  With
``--gui`` it serves the viewer on ``--port`` instead (training, with the
MJPEG stream and JSON control of ``nerf_texture_tpu_torch.viewer``).
``--bound`` > 1 trains a scene larger than the unit cube (1 +
ceil(log2(bound)) cascades), ``--dt_gamma`` > 0 grows the march's step
with distance.  Writes
``W/checkpoints/ngp`` after every eval (and loads it at start with
``--ckpt latest``), ``W/log_ngp.jsonl``, and with ``--save_mesh``
``W/meshes/ngp_mesh.obj``.  Prints ``[done/iters] loss=... PSNR=...``
after every ``--eval_interval`` steps, and the seconds of its stages.
"""

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("path", help="scene dir with transforms.json, or the "
                   "name of a procedural scene (synthetic_sphere)")
    p.add_argument("--workspace", default="./logs/nerf")
    p.add_argument("--iters", type=int, default=12000)
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--bound", type=float, default=1.0)
    p.add_argument("--scale", type=float, default=0.33)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--mode", default="colmap",
                   choices=["colmap", "blender"])
    p.add_argument("--dt_gamma", type=float, default=0.0)
    p.add_argument("--gui", action="store_true")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--save_mesh", action="store_true")
    p.add_argument("--mesh_resolution", type=int, default=256)
    p.add_argument("--ckpt", default="latest")
    p.add_argument("--eval_interval", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default the card; 'cpu' runs the "
                   "kernels' plain versions)")
    return p.parse_args(argv)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
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
    from nerf_texture_tpu_torch.data.provider import NeRFDataset
    from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu_torch.models import ngp
    from nerf_texture_tpu_torch.models.ngp import NGPConfig
    from nerf_texture_tpu_torch.ops.proxy_select import (proxy_select,
                                                         proxy_select_cdf)
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.field_io import save_mesh
    from nerf_texture_tpu_torch.train.trainer import TrainConfig, Trainer

    device = torch.empty(0, device=args.device).device  # raises without it
    t0 = time.perf_counter()
    if args.path == "synthetic_sphere":
        dataset = SyntheticSphereDataset(n_frames=24, H=400, W=400)
    else:
        dataset = NeRFDataset(args.path, mode=args.mode,
                              split="train" if args.mode == "colmap"
                              else "all", downscale=args.downscale,
                              scale=args.scale)
    print(f"setup: scene load {time.perf_counter() - t0:.3f} s "
          f"({dataset.num_frames} frames {dataset.H}x{dataset.W})")

    mcfg = NGPConfig(bound=args.bound)
    rcfg = RenderConfig.for_bound(args.bound, dt_gamma=args.dt_gamma,
                                  max_steps=384)
    tcfg = TrainConfig(lr=args.lr, total_steps=args.iters,
                       num_rays=args.num_rays)
    trainer = Trainer(dataset, mcfg, rcfg, tcfg, seed=args.seed,
                      device=device, workspace=args.workspace)

    ckpt_dir = os.path.join(args.workspace, "checkpoints", "ngp")
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
    while done < args.iters:
        n = min(args.eval_interval, args.iters - done)
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
        print(f"[{done}/{args.iters}] loss={m['loss']:.5f} "
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

    if args.save_mesh:
        params = trainer.state.params

        @torch.no_grad()
        def density_fn(pts):
            return ngp.density(params, pts, mcfg)[0]

        mesh_path = os.path.join(args.workspace, "meshes", "ngp_mesh.obj")
        t0 = time.perf_counter()
        v, f = save_mesh(density_fn, mesh_path,
                         resolution=args.mesh_resolution, bound=args.bound,
                         device=device)
        print(f"mesh: {len(v)} vertices, {len(f)} faces in "
              f"{time.perf_counter() - t0:.2f} s")
        print("mesh saved to", mesh_path)


if __name__ == "__main__":
    main()
