"""The port's training on the card against the port's training on the
CPU, from the same init on the same draws (ROADMAP Queue 3, items 1 and
8, link (b)).  Imports only the port (and ``chip_smoke``'s configs).

Each arm trains three runs side by side in one process: one on the CPU
and two on the card.  All three start from the same params (seeded on a
CPU ``torch.Generator`` and copied to each device), the same grid and,
for the curved field, the same anchor table (the CPU run's); every step
all three take the same draws, made once on a CPU generator and copied
to each device.  So the two card runs differ only by the card's own
run-to-run spread (the float atomics of ``index_add_`` in the table
gradients), and their distance from the CPU run is the card's numerics
against the CPU's.  TF32 is off, as in training.

Arms:

- ``shell``: the textured shell at the FULL profile of
  ``scripts/torch_shell_pipeline.py`` -- the coarse NGP (600 steps,
  generator seed 3 + seed) and then the curved field (500 steps, seed
  4 + seed) on one template, the CPU NGP run's mesh;
- ``bench``: bench.py's NGP and curved arms at full width
  (``chip_smoke``'s BENCH_* and CURVED_* configs, seed 7), their first 48
  steps (three refresh cycles).

Per arm: every step's loss of each run (a TSV under
``build/card_vs_cpu/``), the loss differences card - CPU and card -
card (relative for the NGP, absolute for the curved loss, whose cosine
term takes it through 0), the params' largest absolute difference at the
end (over every leaf, and as a share of the leaf's largest entry), the
held-out PSNR of each run.  One JSON line an arm, to stdout and to
``--out``.

    python3 scripts/torch_train_card_vs_cpu.py --seeds 0 1 --arms shell bench
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as smoke  # noqa: E402
import torch_shell_pipeline as pipe  # noqa: E402
from nerf_texture_tpu_torch.data.poses import orbit_pose  # noqa: E402
from nerf_texture_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticSphereDataset)
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere  # noqa: E402
from nerf_texture_tpu_torch.geometry.projector import (  # noqa: E402
    MeshProjector)
from nerf_texture_tpu_torch.models import curved_field  # noqa: E402
from nerf_texture_tpu_torch.models import mesh_field  # noqa: E402
from nerf_texture_tpu_torch.models import ngp  # noqa: E402
from nerf_texture_tpu_torch.models.curved_field import (  # noqa: E402
    CurvedFieldConfig)
from nerf_texture_tpu_torch.models.mesh_field import (  # noqa: E402
    MeshFieldConfig)
from nerf_texture_tpu_torch.ops import occupancy as occ_mod  # noqa: E402
from nerf_texture_tpu_torch.render.renderer import RenderConfig  # noqa: E402
from nerf_texture_tpu_torch.train import curved_trainer as ct  # noqa: E402
from nerf_texture_tpu_torch.train import trainer as tt  # noqa: E402
from nerf_texture_tpu_torch.utils.metrics import psnr  # noqa: E402

OUT = os.path.join(ROOT, "build", "card_vs_cpu")
DEVICES = ("cpu", "cuda", "cuda")
RUNS = ("cpu", "card_a", "card_b")
BENCH_STEPS = 48


def tree_to(tree, dev):
    """A nested dict / list of tensors copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, dev) for v in tree)
    return tree.detach().to(dev)


def draws_to(nt, dev):
    """A draw tuple (``Batch``, ``CurvedBatch``, ``GridDraws``) with its
    tensors on ``dev``."""
    return type(nt)(*[x.to(dev) if torch.is_tensor(x) else x for x in nt])


# -- the NGP ----------------------------------------------------------------

def ngp_runs(ds, mcfg, rcfg, tcfg, seed: int, steps: int):
    """Three NGP trainers (CPU, card, card) trained ``steps`` steps in
    lockstep; returns (trainers, [run][step] losses)."""
    gen = torch.Generator().manual_seed(seed)
    params = ngp.init(gen, mcfg)
    trs = []
    for dev in DEVICES:
        tr = tt.Trainer(ds, mcfg, rcfg, tcfg, seed=seed, device=dev)
        tr.state = tt.init_train_state(tr.generator, mcfg, rcfg, tcfg,
                                       params=tree_to(params, dev))
        tr.mark_untrained()
        trs.append(tr)
    losses = [[] for _ in trs]
    for step in range(steps):
        if step % tcfg.grid_update_interval == 0:
            full = step // tcfg.grid_update_interval < tcfg.grid_full_updates
            draws = occ_mod.grid_draws(gen, grid_size=rcfg.grid_size,
                                       cascades=rcfg.cascades,
                                       bound=rcfg.bound, full=full)
            for tr in trs:
                tt.grid_step(tr.state, [draws_to(d, tr.device)
                                        for d in draws],
                             mcfg=mcfg, rcfg=rcfg, full=full,
                             decay=tcfg.grid_decay)
        batch = tt.sample_batch(gen, num_frames=ds.num_frames, H=ds.H,
                                W=ds.W, tcfg=tcfg)
        for tr, ls in zip(trs, losses):
            m = tt.train_step(tr.state, draws_to(batch, tr.device), tr.poses,
                              tr.images, tr.intrinsics, mcfg=mcfg, rcfg=rcfg,
                              tcfg=tcfg, H=ds.H, W=ds.W)
            ls.append(m["loss"])
        progress("ngp", step, losses)
    return trs, [torch.stack(ls).tolist() for ls in losses]


# -- the curved field --------------------------------------------------------

def refresh(tr, draws):
    """One grid refresh of ``tr`` over its near cells on ``draws``
    (``CurvedTrainer._refresh`` with the draws given)."""
    state = dataclasses.replace(tr.state,
                                params=tr._infer_params(tr.state.params))
    ct.curved_grid_step(state, tr.field_state,
                        [d.to(tr.device) for d in draws], ccfg=tr.ccfg,
                        rcfg=tr.rcfg, mode=tr.mode, rt=tr.runtime,
                        near_cells=tr._get_near_cells(),
                        anchor_tab=tr._refresh_anchor_tab())
    tr.state.occ = state.occ


def curved_runs(ds, mesh, ccfg, rcfg, tcfg, seed: int, steps: int):
    """Three curved trainers (CPU, card, card) on ``mesh``, one refresh
    (``initialize_states(1)``) then ``steps`` steps in lockstep; returns
    (trainers, [run][step] losses)."""
    gen = torch.Generator().manual_seed(seed)
    params = curved_field.init(gen, ccfg)
    trs = []
    for dev in DEVICES:
        tr = ct.CurvedTrainer(ds, mesh_field.make_state(MeshProjector(
            mesh, device=dev)), ccfg, rcfg, tcfg, seed=seed, device=dev)
        tr.state = ct.init_curved_state(tr.generator, ccfg, rcfg, tcfg,
                                        params=tree_to(params, dev),
                                        n_frames=ds.num_frames)
        if trs:
            tr._anchor_tab = (tr.field_state.projector, tr.anchor_collapse,
                              trs[0]._anchor_table().to(tr.device))
        trs.append(tr)
    n_near = [int(tr._get_near_cells().shape[0]) for tr in trs]
    assert len(set(n_near)) == 1, n_near
    fcfg = ccfg.field

    def grid():
        draws = occ_mod.sparse_draws(gen, n_near[0],
                                     grid_size=rcfg.grid_size,
                                     cascades=rcfg.cascades, bound=rcfg.bound)
        for tr in trs:
            refresh(tr, draws)

    grid()
    losses = [[] for _ in trs]
    for step in range(steps):
        if step % tcfg.grid_update_interval == 0:
            grid()
        level = (int(torch.randint(0, fcfg.num_levels, (), generator=gen))
                 if fcfg.clustering else None)
        batch = ct.sample_curved_batch(gen, num_frames=ds.num_frames,
                                       H=ds.H, W=ds.W, tcfg=tcfg, rcfg=rcfg,
                                       fcfg=fcfg, level=level)
        for tr, ls in zip(trs, losses):
            m = ct.curved_train_step(
                tr.state, draws_to(batch, tr.device), tr.field_state,
                tr.poses, tr.images, tr.intrinsics, ccfg=ccfg, rcfg=rcfg,
                tcfg=tcfg, H=ds.H, W=ds.W, mode=tr.mode, rt=tr.runtime,
                anchor_tab=tr._refresh_anchor_tab())
            ls.append(m["loss"])
        progress("curved", step, losses)
    return trs, [torch.stack(ls).tolist() for ls in losses]


# -- reading the runs -------------------------------------------------------

def progress(stage: str, step: int, losses, every: int = 50):
    if (step + 1) % every == 0:
        print(f"{stage}: step {step + 1}, loss "
              f"{', '.join(f'{float(ls[-1]):.6f}' for ls in losses)}, "
              f"{time.strftime('%H:%M:%S')}", file=sys.stderr, flush=True)


def compare(name: str, trs, losses, relative: bool, pose, gt) -> dict:
    """The runs' loss differences, params' differences and PSNRs; writes
    the per-step TSV."""
    L = np.asarray(losses, np.float64)
    with open(os.path.join(OUT, f"{name}.tsv"), "w") as fh:
        fh.write("step\t" + "\t".join(RUNS) + "\n")
        for i in range(L.shape[1]):
            fh.write(f"{i + 1}\t" + "\t".join(f"{x:.9g}" for x in L[:, i])
                     + "\n")

    def diff(a, b):
        d = np.abs(L[a] - L[b])
        if relative:
            d = d / np.maximum(np.abs(L[b]), 1e-12)
        return {"max": float(d.max()), "mean": float(d.mean()),
                "first_above_1e-2": (int(np.argmax(d > 1e-2)) + 1
                                     if (d > 1e-2).any() else None)}

    leaves = [tt.param_leaves(tr.state.params) for tr in trs]

    def pdiff(a, b):
        worst, share = 0.0, 0.0
        for x, y in zip(leaves[a], leaves[b]):
            d = float((x.detach().cpu().float() - y.detach().cpu().float())
                      .abs().max())
            worst = max(worst, d)
            share = max(share, d / max(float(y.detach().abs().max()), 1e-30))
        return {"max_abs": worst, "max_share_of_leaf": share}

    out = {"arm": name, "steps": L.shape[1], "relative": relative,
           "loss_card_a_vs_cpu": diff(1, 0), "loss_card_b_vs_cpu": diff(2, 0),
           "loss_card_a_vs_card_b": diff(1, 2),
           "params_card_a_vs_cpu": pdiff(1, 0),
           "params_card_b_vs_cpu": pdiff(2, 0),
           "params_card_a_vs_card_b": pdiff(1, 2),
           "loss_last": L[:, -1].tolist()}
    psnrs = []
    for tr in trs:
        with torch.no_grad():
            img = tr.render_frame(pose, use_ema=False)["image"]
        psnrs.append(float(psnr(img, gt)))
    out["psnr"] = dict(zip(RUNS, psnrs))
    return out


def shell(seed: int, emit):
    P = pipe.PROFILES["FULL"]
    ds, pose, gt = pipe.scene(P)
    mk, rk, tk = pipe.ngp_configs(P)
    mcfg, rcfg = ngp.NGPConfig(**mk), RenderConfig(**rk)
    t0 = time.perf_counter()
    trs, losses = ngp_runs(ds, mcfg, rcfg, tt.TrainConfig(**tk), 3 + seed,
                           P["ngp_steps"])
    row = compare(f"shell_ngp_seed{seed}", trs, losses, True, pose, gt)
    emit(row, seconds=time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as work:
        log = pipe.StageLog("cpu")
        mesh, _ = pipe.template_stage(P, ds, trs[0], work, "cpu", log)
    del trs
    fk, ck, tk = pipe.curved_configs(P, log.res["h"])
    ccfg = CurvedFieldConfig(field=MeshFieldConfig(**fk), **ck)
    t0 = time.perf_counter()
    trs, losses = curved_runs(ds, mesh, ccfg, rcfg,
                              ct.CurvedTrainConfig(**tk), 4 + seed,
                              P["curved_steps"])
    row = compare(f"shell_curved_seed{seed}", trs, losses, False, pose, gt)
    emit(row, seconds=time.perf_counter() - t0, h=log.res["h"],
         vertices=log.res["vertices"])


def bench(emit):
    ds = SyntheticSphereDataset(n_frames=8, H=800, W=800)
    pose = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    gt = smoke.white_gt(ds, pose)
    t0 = time.perf_counter()
    mcfg = ngp.NGPConfig(**smoke.BENCH_NGP)
    rcfg = RenderConfig(**smoke.BENCH_RENDER)
    trs, losses = ngp_runs(ds, mcfg, rcfg, tt.TrainConfig(**smoke.BENCH_TRAIN),
                           7, BENCH_STEPS)
    emit(compare("bench_ngp", trs, losses, True, pose, gt),
         seconds=time.perf_counter() - t0)
    del trs
    t0 = time.perf_counter()
    ccfg = CurvedFieldConfig(field=MeshFieldConfig(), light_model="SH")
    trs, losses = curved_runs(ds, make_icosphere(4, radius=0.5), ccfg,
                              RenderConfig(**smoke.CURVED_RENDER),
                              ct.CurvedTrainConfig(**smoke.CURVED_TRAIN), 7,
                              BENCH_STEPS)
    emit(compare("bench_curved", trs, losses, False, pose, gt),
         seconds=time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--arms", nargs="+", choices=["shell", "bench"],
                    default=["shell", "bench"])
    ap.add_argument("--out", default=os.path.join(OUT, "card_vs_cpu.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_card_vs_cpu: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    os.makedirs(OUT, exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def emit(row, **extra):
        row.update(extra, card=card)
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as fh:
            fh.write(json.dumps(row) + "\n")

    if "shell" in args.arms:
        for seed in args.seeds:
            shell(seed, emit)
    if "bench" in args.arms:
        bench(emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
