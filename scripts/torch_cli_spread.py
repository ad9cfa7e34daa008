"""Phase 13's undistilled curved CLI on fixed and on fresh template
meshes (ROADMAP Queue 3, item 4): which half carries the spread of its
24 dB gate, the mesh build or the training.

On phase 13's scene (``SyntheticSphereDataset(24, 400x400)`` as PNGs),
two runs of ``main_nerf_torch.py --save_mesh`` (phase 13's flags) each
write a mesh; ``main_torch.py`` without distillation (phase 13's flags,
700 steps, the eval at step 700) then runs twice on each mesh, the four
runs at once on the card, each in a workspace of its own holding a copy
of its mesh.  The runs go through ``chip_smoke.cli_run`` (logs in
``chiprun_out/spread_*.log``), the scene and workspaces to
``build/cli_spread/``.  One JSON line: each run's eval PSNR, the spread
within each mesh, and the gap between the two meshes' means.  Imports
only the port.

    python3 scripts/torch_cli_spread.py
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from nerf_texture_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticSphereDataset)

WORK = os.path.join("build", "cli_spread")
MESHES, RUNS_A_MESH = 2, 2


def psnr_of(code, out: str, name: str) -> float:
    if code != 0:
        raise RuntimeError(f"{name}: exit {code}: {out[-3000:]}")
    return smoke._evals(out)[-1][2]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_cli_spread: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    scene = os.path.join(WORK, "scene")
    SyntheticSphereDataset(n_frames=24, H=400, W=400).write_to_disk(scene)

    def ngp_run(m):
        return smoke.cli_run(
            ["main_nerf_torch.py", scene, "--workspace",
             os.path.join(WORK, f"ngp{m}"), "--iters",
             str(smoke.CLI_NGP_ITERS), "--eval_interval",
             str(smoke.CLI_NGP_EVAL), "--save_mesh"], f"spread_ngp{m}",
            timeout=1500)

    def plain_run(job):
        m, r = job
        ws = os.path.join(WORK, f"plain{m}_{r}")
        shutil.copytree(os.path.join(WORK, f"ngp{m}", "meshes"),
                        os.path.join(ws, "meshes"))
        return smoke.cli_run(
            ["main_torch.py", scene, "--workspace", ws, "--eval_interval",
             str(smoke.CLI_PLAIN_EVAL), "--iters",
             str(smoke.CLI_PLAIN_ITERS)], f"spread_plain{m}_{r}",
            timeout=1500)

    try:
        with ThreadPoolExecutor(MESHES) as pool:
            ngps = list(pool.map(ngp_run, range(MESHES)))
        ngp_psnr = [psnr_of(c, o, f"ngp{m}")
                    for m, (c, o, _) in enumerate(ngps)]
        jobs = [(m, r) for m in range(MESHES) for r in range(RUNS_A_MESH)]
        with ThreadPoolExecutor(len(jobs)) as pool:
            plains = list(pool.map(plain_run, jobs))
    finally:
        smoke.stop_children()
    psnr = {f"mesh{m}_run{r}": psnr_of(c, o, f"plain{m}_{r}")
            for (m, r), (c, o, _) in zip(jobs, plains)}
    by_mesh = [[psnr[f"mesh{m}_run{r}"] for r in range(RUNS_A_MESH)]
               for m in range(MESHES)]
    means = [sum(v) / len(v) for v in by_mesh]
    row = {"ngp_psnr": ngp_psnr, "plain_psnr": psnr,
           "within_mesh_spread": [max(v) - min(v) for v in by_mesh],
           "between_mesh_means": max(means) - min(means),
           "walls_s": [round(w, 1) for _, _, w in plains],
           "gate": smoke.CLI_PSNR_MIN, "card": card}
    print(json.dumps(row), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "cli_spread.jsonl"), "a") as fh:
        fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
