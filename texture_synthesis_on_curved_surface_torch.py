"""Texture synthesis on a curved surface with the PyTorch port
(``nerf_texture_tpu_torch``): the same arguments and output as
``texture_synthesis_on_curved_surface.py``.

Synthesises the sampled patches of a field npz (``field_io.save_field``)
onto the UV atlas of a target mesh and writes curved_mesh.npz, which
``field_io.load_unhash`` imports.  The queries run on ``--device`` (the
GPU unless asked otherwise); the synthesis loop runs on the host.

Usage:
  python texture_synthesis_on_curved_surface_torch.py \
      logs/<scene>/field/<name>.npz path/to/target_mesh.obj \
      --grid_gap 5e-4 --out logs/<scene>/field/curved_mesh.npz
"""

import argparse
import os
import time

import numpy as np

from nerf_texture_tpu_torch.geometry import shape_tools
from nerf_texture_tpu_torch.geometry.mesh import load_obj
from nerf_texture_tpu_torch.geometry.projector import MeshProjector
from nerf_texture_tpu_torch.synthesis.curved import (CurvedSynthesisConfig,
                                                     augment_patches,
                                                     define_vector_field,
                                                     synthesis_on_uvmap,
                                                     uv2vert)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("field_npz")
    p.add_argument("target_mesh")
    p.add_argument("--grid_gap", type=float, default=5e-4)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--no_mirror", action="store_true")
    p.add_argument("--no_crop_shift", action="store_true")
    p.add_argument("--preprocess", action="store_true",
                   help="CoACD + manifold + remesh + smooth the target")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the queries run (default: the GPU)")
    return p


def synthesise(field_npz: str, target_mesh: str, *, grid_gap: float = 5e-4,
               resolution: int = 512, mirror: bool = True,
               crop_shift: bool = True, preprocess: bool = False,
               out: str | None = None, device="cuda",
               max_iters: int | None = None, progress: bool = True,
               stats: dict | None = None) -> str:
    """Synthesise the patches of ``field_npz`` onto the OBJ
    ``target_mesh`` (normalised at scale 1.5) and write curved_mesh.npz
    (default: beside the field npz); returns its path.  ``max_iters``
    caps the loop (default ``CurvedSynthesisConfig``'s); ``stats``
    receives the loop's (``synthesis_on_uvmap``) and ``setup_s``, the
    seconds of the patch library, the projector and ``uv2vert``, and
    ``texels``, the UV texels on the surface."""
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    data = np.load(field_npz, allow_pickle=True)
    patches = augment_patches(data["patches"], mirror_hor=mirror,
                              mirror_vert=mirror, crop_shift=crop_shift)
    if progress:
        print("patch library:", patches.shape)

    mesh_path = target_mesh
    if preprocess:
        mesh_path = shape_tools.coacd(mesh_path)
        mesh_path = shape_tools.manifold_union(
            mesh_path, os.path.dirname(field_npz) or ".")
    mesh = load_obj(mesh_path)
    if preprocess:
        mesh = shape_tools.remesh_isotropic(mesh)
        mesh = shape_tools.laplacian_smooth(mesh)
    mesh = shape_tools.normalize_mesh(mesh, scale=1.5)

    mp = MeshProjector(mesh, device=device)
    verts, vert_ids, res = uv2vert(mp, resolution=resolution)
    vectors = define_vector_field(mp.mesh)
    stats["setup_s"] = time.perf_counter() - t0
    stats["texels"] = len(verts)
    cfg = CurvedSynthesisConfig(grid_gap=grid_gap, resolution=resolution)
    if max_iters is not None:
        cfg.max_iters = max_iters
    result = synthesis_on_uvmap(mp, verts, vert_ids, res, patches, vectors,
                                original_grid_gap=float(data["grid_gap"]),
                                cfg=cfg, progress=progress, stats=stats)
    out_path = out or os.path.join(os.path.dirname(field_npz),
                                   "curved_mesh.npz")
    np.savez(out_path, **{k: v for k, v in result.items() if v is not None})
    return out_path


def main(argv=None):
    args = parser().parse_args(argv)
    t0 = time.perf_counter()
    stats = {}
    out_path = synthesise(
        args.field_npz, args.target_mesh, grid_gap=args.grid_gap,
        resolution=args.resolution, mirror=not args.no_mirror,
        crop_shift=not args.no_crop_shift, preprocess=args.preprocess,
        out=args.out, device=args.device, stats=stats)
    print(f"synthesis: {stats['iters']} iterations, {stats['total_s']:.2f} s "
          f"({stats['device_s']:.2f} s in the device queries), "
          f"{100 * stats['done']:.1f}% of {stats['texels']} texels set; "
          f"{time.perf_counter() - t0:.2f} s in all")
    print("saved", out_path)


if __name__ == "__main__":
    main()
