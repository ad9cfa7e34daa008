#!/usr/bin/env python3
"""The mesh projector's set-up on the card at the meshes of chip_smoke's
phase 12: ``MeshProjector(mesh, device="cuda")`` as ``field_io.load_shape``
builds it on the rounded box target (``make_box((0.5, 0.35, 0.25))``
subdivided to >= 10,000 vertices, 8 Laplacian steps, normalised to 1.2:
24,578 vertices), and as ``field_io.unhash`` builds it on the template
(``make_icosphere(4, 0.5)``) subdivided to >= 40,000 and >= 100,000
vertices (40,962 and 163,842).

    python3 scripts/torch_projector_build.py [--root DIR] [--repeat 2]

For each mesh, each of ``--repeat`` times: the projector's wall (host
bookkeeping, UV atlas, TBNs and both grid indexes, synchronised), and
the two grid builds alone (``spatial.build_grid`` at M 16 and
``spatial.build_triangle_grid`` at M 24, at the projector's grid
resolution).  ``--root`` imports the port from another checkout (say,
the parent commit unpacked under build/), so that two versions of the
builders run in one call on one card.  One JSON line a mesh, with the
card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def meshes():
    from nerf_texture_tpu_torch.geometry.mesh import make_box, make_icosphere
    from nerf_texture_tpu_torch.geometry.shape_tools import (
        laplacian_smooth, normalize_mesh, subdivide_to)

    box = laplacian_smooth(subdivide_to(make_box((0.5, 0.35, 0.25)), 10000),
                           8)
    yield "load_shape box", normalize_mesh(box, scale=1.2)
    for n in (40000, 100000):
        yield f"unhash template >= {n}", subdivide_to(
            make_icosphere(4, radius=0.5), n)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_projector_build: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from nerf_texture_tpu_torch.geometry import spatial
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    try:        # build the table kernels first, where the checkout has them
        from nerf_texture_tpu_torch import native
        native.available()
    except ImportError:
        pass
    for name, m in meshes():
        res = int(np.clip(round(len(m.vertices) ** (1 / 3) * 2), 8, 64))
        row = {"mesh": name, "vertices": len(m.vertices),
               "faces": len(m.faces), "grid_res": res, "root": args.root,
               "card": card, "projector_s": [], "vgrid_s": [],
               "tgrid_s": []}
        for _ in range(args.repeat):
            row["projector_s"].append(timed(
                lambda: MeshProjector(m, device=dev))[1])
            row["vgrid_s"].append(timed(lambda: spatial.build_grid(
                m.vertices, res, 16, device=dev))[1])
            row["tgrid_s"].append(timed(lambda: spatial.build_triangle_grid(
                m.vertices, m.faces, res, 24, device=dev))[1])
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
