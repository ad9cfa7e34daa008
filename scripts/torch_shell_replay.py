"""Where a seed of the shell pipeline parts between the card and the CPU:
stages 1-4 of ``scripts/torch_shell_pipeline.py`` (coarse NGP, mesh,
template, curved training) on the card, then stages 5-6 (patch export,
quilting, ``load_field`` and its frame) twice from the one trained curved
field: on the card, and on the CPU (a CPU trainer on the same template
with the card trainer's checkpoint loaded).  Training on the card is not
bit-reproducible (its scatter-adds are atomic), so the same seed gives
another field on each run; the replay tells a fault of the card's export
and import path (the two sides part) from a field that is only another
draw (they agree).

One JSON line a run (and the same to ``--out``): the seed and repeat,
the card side's NGP and curved PSNRs, vertices and h; for each side the
patch count, the canvas's weights_sum max, lit pixels (weights_sum >
0.1) and their std, and the failed gates; and between the sides the max
abs difference of the exported patches, of the quilted texture's
features, and of the two canvas frames.  Prints the card's name and
power limit first.

    python3 scripts/torch_shell_replay.py --seeds 0 1 2 --repeats 2
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_shell_pipeline as pipe  # noqa: E402


def _max_abs(a, b):
    """Max abs difference of two arrays, None where the shapes differ."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) if a.shape == b.shape else None


def replay(seed: int, workdir: str, profile: str = "FULL",
           device: str = "cuda") -> dict:
    """One run: stages 1-4 on ``device``, 5-6 there and on the CPU."""
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector

    P = pipe.PROFILES[profile]
    log = pipe.StageLog(device, seed=seed)
    ds, pose, gt = pipe.scene(P)
    tr, rcfg = pipe.ngp_stage(P, ds, pose, gt, seed, device, log)
    card_dir = os.path.join(workdir, "card")
    cpu_dir = os.path.join(workdir, "cpu")
    os.makedirs(card_dir)
    os.makedirs(cpu_dir)
    mesh, mp = pipe.template_stage(P, ds, tr, card_dir, device, log)
    del tr
    ctr = pipe.curved_stage(P, ds, mp, rcfg, pose, gt, seed, device,
                             log)
    ckpt = os.path.join(workdir, "ckpt")
    ctr.save_checkpoint(ckpt)

    cpu_log = pipe.StageLog("cpu", h=log.res["h"])
    cpu_ctr = pipe.curved_trainer(P, ds, MeshProjector(mesh, device="cpu"),
                                  log.res["h"], rcfg, seed, "cpu")
    cpu_ctr.load_checkpoint(ckpt)
    sides = {}
    for name, lg, tr_, d in (("card", log, ctr, card_dir),
                             ("cpu", cpu_log, cpu_ctr, cpu_dir)):
        failed0 = len(lg.res["failed"])
        paths = pipe.export_stage(tr_, mesh, d, lg)
        out = pipe.import_stage(tr_, ds, paths[1], lg)
        sides[name] = {
            "paths": paths, "image": out["image"].cpu().numpy(),
            "res": {k: lg.res[k] for k in ("patches", "patch_std",
                                           "field_ws_max", "field_lit",
                                           "field_std")},
            "failed": lg.res["failed"][failed0:]}
    card, cpu = sides["card"], sides["cpu"]
    fc, fu = (np.load(s["paths"][0]) for s in (card, cpu))
    tc, tu = (np.load(s["paths"][1]) for s in (card, cpu))
    return {"seed": seed,
            **{k: log.res[k] for k in ("ngp_psnr", "curved_psnr",
                                       "vertices", "h")},
            "failed_before_export": [g for g in log.res["failed"]
                                     if g not in card["failed"]],
            "card": {**card["res"], "failed": card["failed"]},
            "cpu": {**cpu["res"], "failed": cpu["failed"]},
            "patches_max_abs": _max_abs(fc["patches"], fu["patches"]),
            "texture_max_abs": _max_abs(tc["features"], tu["features"]),
            "canvas_max_abs": _max_abs(card["image"], cpu["image"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--out", default=None,
                    help="append one JSON object a run to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_shell_replay: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    for r in range(args.repeats):
        for s in args.seeds:
            with tempfile.TemporaryDirectory() as d:
                res = {**replay(s, d), "repeat": r, "device": card}
            line = json.dumps(res)
            print(line, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                            exist_ok=True)
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
