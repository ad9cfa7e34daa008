"""Times two frames of the port in another checkout beside this tree's, in
turns on one CUDA card: the trained NGP's inverse-CDF frame and the
trained curved model's baked cap-5 frame at 800x800.

    python3 scripts/torch_frame_ab.py DIR

DIR holds another commit's ``nerf_texture_tpu_torch/`` (say the parent's:
``mkdir -p build/parent && git archive <commit> nerf_texture_tpu_torch |
tar -x -C build/parent``), imported as the package ``other_port`` (its
kernels build from its own ``csrc/`` into DIR/build/kernels).  The models
are trained once, by this tree: the NGP as ``chip_smoke.py``'s phase 7
(bench.py's NGP arm, 50 + 650 steps), the curved model with bench.py's
curved configs for ``CURVED_STEPS`` steps (phase 10 trains 700), baked
and rendered at phase 10's baked settings (block 8, tau_cull 0.1, K 16,
cap 5).  Both sides render the same trained state through their own
renderer: the NGP through ``render_frame`` of each tree, the curved model
through ``CurvedTrainer.render_frame`` of each tree (a shallow copy of the
trainer whose class is the other tree's).

``PAIRS`` pairs of passes, the pair's order alternating (other first in
the even pairs).  A pass renders a warm-up frame, then 3 novel poses
(wall ms each, synchronised), and profiles one under torch.profiler (its
CUDA kernels and their device ms).  Prints the card's name and power
limit first, one line a pass, and one line a frame: each side's median
wall, mean kernel ms and kernels a frame, the median of the pairs'
differences (this - other) of the pass mean walls, the pairs in which
this tree was the slower, and the largest difference between the two
sides' frames.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402

CURVED_STEPS = 300
PAIRS = 12


def load_other(root: str):
    """The port under ``root``, imported as the package ``other_port`` so
    that it sits beside this tree's."""
    pkg = Path(root).resolve() / "nerf_texture_tpu_torch"
    if not (pkg / "__init__.py").is_file():
        raise SystemExit(f"torch_frame_ab: no nerf_texture_tpu_torch/ "
                         f"under {root}")
    spec = importlib.util.spec_from_file_location(
        "other_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_port"] = mod
    spec.loader.exec_module(mod)
    return mod


def timed_pass(render, poses) -> dict:
    render(poses[0])                                   # warm-up
    walls, outs = [], []
    for p in poses[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(render(p))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    n_k, k_ms = smoke.profile_frame(lambda: render(poses[1]))
    return {"walls": walls, "kernels": n_k, "kernel_ms": k_ms,
            "image": outs[0]["image"], "chunks": outs[0]["chunks"],
            "live": outs[0]["live"]}


def ab(name: str, renders: dict, poses, card: str) -> dict:
    """``PAIRS`` pairs of passes of ``renders`` {"other", "this"}."""
    runs = {"other": [], "this": []}
    for i in range(PAIRS):
        order = ("other", "this") if i % 2 == 0 else ("this", "other")
        for side in order:
            r = timed_pass(renders[side], poses)
            runs[side].append(r)
            print(f"frame_ab: {name}: pair {i} {side}: walls "
                  f"{', '.join(f'{w:.2f}' for w in r['walls'])} ms; "
                  f"{r['kernels']} kernels, {r['kernel_ms']:.2f} ms of "
                  f"kernel time; live {r['live']}, chunks {r['chunks']} "
                  f"({card})")
    out = {}
    for side, rs in runs.items():
        out[side] = {
            "wall_ms": float(np.median([w for r in rs for w in r["walls"]])),
            "kernel_ms": float(np.mean([r["kernel_ms"] for r in rs])),
            "kernels": float(np.mean([r["kernels"] for r in rs])),
            "pass_ms": [float(np.mean(r["walls"])) for r in rs]}
    o, t = out["other"], out["this"]
    d = np.subtract(t["pass_ms"], o["pass_ms"])
    diff = float((runs["this"][0]["image"]
                  - runs["other"][0]["image"]).abs().max())
    print(f"frame_ab: {name}: median wall other {o['wall_ms']:.2f}, this "
          f"{t['wall_ms']:.2f} ms ({100 * (t['wall_ms'] / o['wall_ms'] - 1):+.1f}%); "
          f"kernel other {o['kernel_ms']:.3f}, this {t['kernel_ms']:.3f} ms "
          f"({100 * (t['kernel_ms'] / o['kernel_ms'] - 1):+.1f}%); kernels a "
          f"frame other {o['kernels']:.0f}, this {t['kernels']:.0f}; pairs' "
          f"wall difference (this - other) median {np.median(d):+.2f} ms, "
          f"this slower in {int((d > 0).sum())} of {PAIRS}; frames' max abs "
          f"{diff:.3g} ({card})")
    out["pair_diff_ms"] = d.tolist()
    out["max_abs"] = diff
    return out


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        print("torch_frame_ab: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    other = load_other(sys.argv[1])
    other_trainer = importlib.import_module("other_port.train.trainer")
    other_curved = importlib.import_module("other_port.train.curved_trainer")
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field, ngp
    from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
    from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
    from nerf_texture_tpu_torch.render.renderer import (PrepassState,
                                                        RenderConfig)
    from nerf_texture_tpu_torch.train.curved_trainer import (
        CurvedTrainConfig, CurvedTrainer)
    from nerf_texture_tpu_torch.train.trainer import (
        TrainConfig, Trainer, ngp_infer_params, render_frame)

    dev = torch.device("cuda", 0)
    ds = SyntheticSphereDataset(n_frames=8, H=800, W=800)
    poses = [orbit_pose(1.25 + 0.1 * i, 2 * np.pi * (i + 0.5) / 8, 2.0)
             for i in range(4)]
    # -- the NGP, trained as phase 7 ----------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    mcfg = ngp.NGPConfig(**smoke.BENCH_NGP)
    rcfg = RenderConfig(**smoke.BENCH_RENDER)
    tr = Trainer(ds, mcfg, rcfg, TrainConfig(**smoke.BENCH_TRAIN), seed=7,
                 device=dev)
    t0 = time.perf_counter()
    tr.train(smoke.WARM_STEPS + smoke.TRAIN_STEPS)
    torch.cuda.synchronize()
    print(f"frame_ab: NGP trained {tr.state.step} steps in "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    torch.backends.cuda.matmul.allow_tf32 = True
    iparams = ngp_infer_params(tr.state.params, mcfg)
    prepass = PrepassState.build(tr.state.occ.occ, rcfg,
                                 density=tr.state.occ.density)
    ab("NGP trained CDF cap 4", {
        side: (lambda p, f=f: f(iparams, None, p, ds.intrinsics, 800, 800,
                                mcfg, rcfg, prepass=prepass))
        for side, f in (("other", other_trainer.render_frame),
                        ("this", render_frame))}, poses, card)
    del tr, iparams, prepass
    torch.cuda.empty_cache()
    # -- the curved model, baked ----------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    ctr = CurvedTrainer(ds, mesh_field.make_state(MeshProjector(
        make_icosphere(4, radius=0.5), device=dev)),
        CurvedFieldConfig(field=MeshFieldConfig(), light_model="SH"),
        RenderConfig(**smoke.CURVED_RENDER),
        CurvedTrainConfig(**smoke.CURVED_TRAIN), seed=7, device=dev)
    t0 = time.perf_counter()
    ctr.initialize_states(1)
    ctr.train(CURVED_STEPS)
    torch.cuda.synchronize()
    print(f"frame_ab: curved trained {ctr.state.step} steps in "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    ctr.rcfg = dataclasses.replace(ctr.rcfg, **smoke.CURVED_BAKED)
    ctr.bake_atlas()
    octr = copy.copy(ctr)
    octr.__class__ = other_curved.CurvedTrainer
    ab("curved baked K 16 cap 5", {
        side: (lambda p, t=t: t.render_frame(p, use_ema=False, baked=True))
        for side, t in (("other", octr), ("this", ctr))}, poses, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
