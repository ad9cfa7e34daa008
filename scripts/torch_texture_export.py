#!/usr/bin/env python3
"""Time the port's patch export at full size on a CUDA card.

    python3 scripts/torch_texture_export.py [--patches 2000]

Builds the curved model at the width of ``bench.py``'s curved arm
(``MeshFieldConfig()``, SH light, ``make_icosphere(4, 0.5)``, grid 128)
with seeded weights (the export's cost depends on the geometry, not on
the training), refreshes its grid once, and then:

- times, on one batch of ``PatchSampleConfig``'s 16 centres x 128^2 texel
  rays, each stage of ``sample_patches``' device half: the ray cast
  (``spatial.raycast``, 64 steps), the exact projection
  (``projector.project``: kNN normal, two 12-step casts) and the encode
  (packed hash grid + phi embedding): the stream's time between CUDA
  events (median of 5) and the kernel time of one traced call;
- runs ``sample_patches`` with ``--patches`` patches (the default is
  PatchSampleConfig's 2000) and prints its seconds, candidates, kept
  patches and rays cast a second (the npz write of ``save_field`` is not
  part of it: 2000 patches are ~4.7 GB).

Prints the card's name and power limit first, and fails without a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def stage_ms(fn, reps: int = 5) -> tuple[float, float]:
    """(median ms between CUDA events around fn(), over reps calls -- the
    stream's time, the host's launch gaps included; ms of kernel time of
    one traced call, torch.profiler)."""
    import chip_smoke as cs

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), cs.profile_frame(fn)[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--patches", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_texture_export: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke as cs
    from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu_torch.geometry import projector as proj
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.spatial import raycast
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.synthesis import patches
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)

    dev = torch.device("cuda", 0)
    mesh = make_icosphere(4, radius=0.5)
    tr = CurvedTrainer(SyntheticSphereDataset(n_frames=2, H=64, W=64),
                       mesh_field.make_state(proj.MeshProjector(
                           mesh, device=dev)),
                       CurvedFieldConfig(field=MeshFieldConfig(),
                                         light_model="SH"),
                       RenderConfig(**cs.CURVED_RENDER),
                       CurvedTrainConfig(**cs.CURVED_TRAIN), seed=7,
                       device=dev)
    cs.seeded_curved(tr, cs.TABLE_SCALE)
    tr.initialize_states(1)
    fcfg, st = tr.ccfg.field, tr.field_state
    params = tr.state.params["field"]
    pa = st.projector

    # -- one batch, stage by stage ---------------------------------------
    scfg = patches.PatchSampleConfig(max_patch_num=args.patches)
    ps, B = scfg.patch_size, scfg.center_batch
    # B centres' texel rays, framed as sample_patches frames them
    centers = patches.poisson_disk_sample(mesh, B, 0)
    normals = mesh.vertex_normals[np.argmin(
        ((mesh.vertices[None] - centers[:, None]) ** 2).sum(-1), 1)]
    first = patches.pca_first_component(mesh.vertices)
    gap = mesh.mean_edge_length * scfg.pattern_rate
    cal = np.linspace(-ps * gap / 2, ps * gap / 2, ps)
    gx, gy = np.meshgrid(cal, cal, indexing="ij")
    texels = np.stack([gx.ravel(), gy.ravel(), np.zeros(ps * ps)], -1)
    origins = []
    for c, z in zip(centers, normals):
        y = np.cross(z, first)
        y /= np.linalg.norm(y)
        R = np.stack([np.cross(y, z), y, z], -1)
        origins.append(texels @ R.T + c + 0.1 * z)
    o = torch.as_tensor(np.concatenate(origins), dtype=torch.float32,
                        device=dev)
    d = torch.as_tensor(np.repeat(-normals, ps * ps, 0), dtype=torch.float32,
                        device=dev)
    hit = {}

    def cast():
        hit["p"], _, hit["depth"], _ = raycast(pa.tgrid, pa.vertices,
                                               pa.faces, o, d)

    cast_ms = stage_ms(cast)
    p_hit = hit["p"][hit["depth"] < 9.5]
    project_ms = stage_ms(lambda: proj.project(
        pa, p_hit, k=fcfg.k, h_threshold=fcfg.h_threshold))
    both = stage_ms(lambda: patches.encode_texels(params, st, fcfg, p_hit))
    encode_ms = tuple(b - p for b, p in zip(both, project_ms))
    for i, what in enumerate(("stream time (CUDA events, median of 5)",
                              "kernel time (torch.profiler)")):
        total = cast_ms[i] + project_ms[i] + encode_ms[i]
        print(f"export batch, {what}: {o.shape[0]} texel rays, "
              f"{p_hit.shape[0]} hits; ray cast {cast_ms[i]:.2f} ms "
              f"({100 * cast_ms[i] / total:.1f}%), exact projection "
              f"{project_ms[i]:.2f} ms ({100 * project_ms[i] / total:.1f}%), "
              f"encode {encode_ms[i]:.2f} ms "
              f"({100 * encode_ms[i] / total:.1f}%) ({card})")

    # -- the whole export -------------------------------------------------
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = patches.sample_patches(params, st, fcfg, mesh, scfg, stats=stats)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    print(f"export: {args.patches} patches requested, {len(out['patches'])} "
          f"kept of {stats['candidates']} candidate centres in {s:.2f} s; "
          f"{stats['rays']} texel rays cast = {stats['rays'] / s:.4g} rays/s "
          f"({card})")
    # the y >= 0 veto drops about half of the 2x oversampled candidates,
    # so the budget is a ceiling (1993 of 2000 on the bench sphere)
    return 0 if len(out["patches"]) > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
