"""The port's bench-width PSNR cells on the card over several seeds
(ROADMAP Queue 3, items 1 and 2; the card's side of link (c), beside
``scripts/bench_cells_jax.py``'s JAX-on-CPU cells).

For each seed, ``chip_smoke.py``'s phases 7-8 (``ngp_train_render``: the
NGP arm of bench.py, 50 + 650 steps, the training-view and novel-view
PSNRs) and 10 (``curved_train_phase``: the curved arm, 700 steps, then
live, pool, EMA parity, the live field at K 16 / block 8, baked K 16 cap
5 and baked K 20 cap 6 at the novel pose) run with their trainers seeded
``seed``.  Their gates are recorded rather than raised, so that every
seed gives its cells (the smoke itself raises on them).  One JSON line a
seed, to stdout and to ``--out``.  Imports only the port.

    python3 scripts/torch_bench_cells.py --seeds 7 8 9
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from nerf_texture_tpu_torch.models import ngp  # noqa: E402
from nerf_texture_tpu_torch.render.renderer import RenderConfig  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 8, 9])
    ap.add_argument("--out", default=os.path.join(
        "chiprun_out", "bench_cells_torch.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bench_cells: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    # as the smoke's main: TF32 for the NGP frames, off in the phases that
    # train or shade f32 operands (they set it themselves)
    torch.backends.cuda.matmul.allow_tf32 = True
    failed: list[str] = []

    def record(cond: bool, msg: str):
        if not cond:
            failed.append(msg)
            print(f"torch_bench_cells: gate failed: {msg}", flush=True)

    smoke.check = record
    mcfg = ngp.NGPConfig(**smoke.BENCH_NGP)
    rcfg = RenderConfig(**smoke.BENCH_RENDER)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in args.seeds:
        failed.clear()
        ds, _, ngp_psnr = smoke.ngp_train_render(dev, card, mcfg, rcfg,
                                                 lambda name: None,
                                                 seed=seed)
        res, tr = smoke.curved_train_phase(dev, card, ds, {}, seed=seed)
        del tr
        torch.cuda.empty_cache()
        cells = res["psnrs"]
        row = {"seed": seed, "ngp": ngp_psnr, "curved": cells,
               "pool_minus_baked_k16": cells["pool"] - cells["baked"],
               "pool_minus_live_k16": cells["pool"] - cells["live_k16"],
               "failed_gates": list(failed), "card": card}
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as fh:
            fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
