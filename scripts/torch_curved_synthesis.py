"""Time the port's curved-surface synthesis on the card at the smoke's
shapes, and run the synthesis CLI at its defaults.

Exports 256 patches of 128^2 texels (``PatchSampleConfig``'s shapes, the
smoke's cut of the budget) from a seeded curved field at the width of
``bench.py``'s curved arm, writes the smoke's target mesh (a rounded box,
``chip_smoke.surface_target``) as an OBJ, then runs the synthesis of
``texture_synthesis_on_curved_surface_torch.py`` (a 512^2 UV map, the
matcher on) for ``--iters`` iterations at each ``--gaps`` grid gap and
prints a line each: set-up seconds, seconds an iteration split into the
device queries and the host, the share of UV texels set, and the
process's peak RSS.  With ``--cli SECONDS`` it then runs the CLI itself
at its defaults (grid gap 5e-4) on the same files for at most SECONDS
and prints the end of its output (its progress lines every 10
iterations).  It needs a CUDA card; run it from the repo root:

    python3 scripts/torch_curved_synthesis.py [--gaps [5e-4 2e-3 4e-3]]
        [--iters 10] [--cli 1800]
"""

import argparse
import os
import resource
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import texture_synthesis_on_curved_surface_torch as cli  # noqa: E402
from nerf_texture_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticSphereDataset)
from nerf_texture_tpu_torch.geometry.mesh import (  # noqa: E402
    make_icosphere, save_obj)
from nerf_texture_tpu_torch.geometry.projector import (  # noqa: E402
    MeshProjector)
from nerf_texture_tpu_torch.models import mesh_field  # noqa: E402
from nerf_texture_tpu_torch.models.curved_field import (  # noqa: E402
    CurvedFieldConfig)
from nerf_texture_tpu_torch.models.mesh_field import (  # noqa: E402
    MeshFieldConfig)
from nerf_texture_tpu_torch.render.renderer import RenderConfig  # noqa: E402
from nerf_texture_tpu_torch.synthesis.patches import (  # noqa: E402
    PatchSampleConfig)
from nerf_texture_tpu_torch.train import field_io  # noqa: E402
from nerf_texture_tpu_torch.train.curved_trainer import (  # noqa: E402
    CurvedTrainConfig, CurvedTrainer)

# the export and the libraries are large: the files and the CLI's log go
# to build/
OUT = os.path.join("build", "curved_synthesis")
LOG = os.path.join(OUT, "cli.log")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--gaps", type=float, nargs="*",
                   default=[5e-4, 2e-3, 4e-3],
                   help="grid gaps to time (none: only the CLI)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--cli", type=float, default=0.0,
                   help="seconds for the CLI at its defaults (0: skip)")
    args = p.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    os.makedirs(OUT, exist_ok=True)
    field_path = os.path.join(OUT, "field.npz")
    target_path = os.path.join(OUT, "target.obj")

    t0 = time.perf_counter()
    tr = CurvedTrainer(
        SyntheticSphereDataset(n_frames=2, H=64, W=64),
        mesh_field.make_state(MeshProjector(make_icosphere(4, radius=0.5),
                                            device=dev)),
        CurvedFieldConfig(field=MeshFieldConfig(), light_model="SH"),
        RenderConfig(**cs.CURVED_RENDER),
        CurvedTrainConfig(**cs.CURVED_TRAIN), seed=7, device=dev)
    cs.seeded_curved(tr, cs.TABLE_SCALE)
    tr.initialize_states(1)
    exp = field_io.save_field(tr, field_path, mesh=make_icosphere(4, 0.5),
                              scfg=PatchSampleConfig(
                                  max_patch_num=cs.TEXTURE_PATCHES))
    print(f"export: {exp['patches'].shape} patches, grid gap "
          f"{float(exp['grid_gap']):.4g}, {time.perf_counter() - t0:.2f} s")
    del exp, tr
    t0 = time.perf_counter()
    target = cs.surface_target()
    save_obj(target_path, target)
    print(f"target: {len(target.vertices)} vertices, {len(target.faces)} "
          f"faces in {time.perf_counter() - t0:.2f} s")

    for gap in args.gaps:
        stats = {}
        cli.synthesise(field_path, target_path, grid_gap=gap,
                       resolution=cs.SURFACE_RES, device=dev,
                       max_iters=args.iters, progress=False,
                       out=os.path.join(OUT, f"curved_{gap:g}.npz"),
                       stats=stats)
        loop = stats["loop_s"]
        it = max(stats["iters"], 1)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        print(f"synthesis gap {gap:g}: set-up {stats['setup_s']:.2f} s, "
              f"{stats['iters']} iterations in {loop:.2f} s = "
              f"{loop / it:.3f} s an iteration ({stats['device_s'] / it:.3f} "
              f"s device queries, {(loop - stats['device_s']) / it:.3f} s "
              f"host); {100 * stats['done']:.2f}% of {stats['texels']} UV "
              f"texels set; peak RSS {rss:.2f} GiB ({card})", flush=True)

    if args.cli > 0:
        t0 = time.perf_counter()
        res = subprocess.run(
            ["timeout", str(int(args.cli)), sys.executable, "-u",
             "texture_synthesis_on_curved_surface_torch.py", field_path,
             target_path, "--out", os.path.join(OUT, "curved_cli.npz")],
            capture_output=True, text=True)
        os.makedirs(os.path.dirname(LOG), exist_ok=True)
        with open(LOG, "w") as f:
            f.write(res.stdout + res.stderr)
        tail = res.stdout.strip().splitlines()[-4:]
        print(f"cli at its defaults: exit {res.returncode} after "
              f"{time.perf_counter() - t0:.1f} s (limit {args.cli:.0f} s); "
              f"last lines: {' | '.join(tail)} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
