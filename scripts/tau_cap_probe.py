"""Does the tau sweep's cap of 4096 hit blocks cost the trained curved
frames quality?  (ROADMAP Queue 3, item 2.)

The block prepass carves each 800x800 frame's blocks by the proxy
density, but sweeps only the first min(4096, blocks) hit blocks
(``render/renderer.py::_prepass_compact``); blocks past the cap keep
their full span.  This script trains the curved model as
``chip_smoke.py`` phase 10 does (the width and 700 steps of
``bench.py``'s curved arm, seed 7), then renders the live frame at the
novel pose at K 24 (the live settings, block 4) and at K 16 (the baked
arm's settings, block 8, tau_cull 0.1), each with the cap and with the
cap lifted, and prints PSNR against the ground truth, live rays and
ms/frame (median of 3) for each, beside the pool frame's PSNR.  The cap
is lifted by a copy of the sweep function in this script, patched into
the renderer for those frames only; the package is not changed.  It
needs a CUDA card; run it from the repo root:

    python3 scripts/tau_cap_probe.py
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from nerf_texture_tpu_torch.data.poses import orbit_pose  # noqa: E402
from nerf_texture_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticSphereDataset)
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere  # noqa: E402
from nerf_texture_tpu_torch.geometry.projector import (  # noqa: E402
    MeshProjector)
from nerf_texture_tpu_torch.models import mesh_field  # noqa: E402
from nerf_texture_tpu_torch.models.curved_field import (  # noqa: E402
    CurvedFieldConfig)
from nerf_texture_tpu_torch.models.mesh_field import (  # noqa: E402
    MeshFieldConfig)
from nerf_texture_tpu_torch.render import renderer  # noqa: E402
from nerf_texture_tpu_torch.render.renderer import (  # noqa: E402
    RenderConfig, _first_true, _live_permutation, _max3x3, _occ_ray_hits,
    _proxy_sigma)
from nerf_texture_tpu_torch.train.curved_trainer import (  # noqa: E402
    CurvedTrainConfig, CurvedTrainer)
from nerf_texture_tpu_torch.utils.metrics import psnr  # noqa: E402

SETTINGS = (("K 24 (live, block 4)", {}),
            ("K 16 (baked arm's, block 8)", cs.CURVED_BAKED))


def prepass_compact_uncapped(ro_b, rd_b, occ_dil, aabb, bound, min_near, *,
                             grid_size: int, margin_steps: float, H: int,
                             W: int, Hb: int, Wb: int, B: int, nb: int,
                             dens8=None, tau_cull: float = 0.0,
                             tau_samples: int = 32):
    """``renderer._prepass_compact`` with the sweep over every hit block
    (TAUB = nb in place of min(4096, nb)); otherwise the same code."""
    hit, t0, t1 = _occ_ray_hits(ro_b, rd_b, occ_dil, aabb, bound, min_near,
                                grid_size, margin_steps=margin_steps)
    n_hit = torch.sum(hit.to(torch.int64))
    if dens8 is not None and tau_cull > 0.0 and B > 1:
        K = tau_samples
        TAUB = nb
        bidx = torch.argsort((~hit).to(torch.uint8), stable=True)[:TAUB]
        ro_c, rd_c = ro_b[bidx], rd_b[bidx]
        t0_c, t1_c = t0[bidx], t1[bidx]
        span = torch.clamp(t1_c - t0_c, min=0.0)
        dt = span / K
        frac = (torch.arange(K, dtype=ro_b.dtype, device=ro_b.device)
                + 0.5) / K
        ts = t0_c[:, None] + span[:, None] * frac
        sig = _proxy_sigma(dens8, ro_c, rd_c, ts, grid_size, bound)
        sdt = sig * dt[:, None]
        alpha_c = 1.0 - torch.exp(-torch.sum(sdt, -1))
        covered = torch.zeros((nb,), dtype=torch.bool, device=hit.device)
        covered[bidx] = True
        alpha = torch.zeros((nb,), dtype=ro_b.dtype, device=hit.device)
        alpha[bidx] = alpha_c
        alpha = torch.where(covered, alpha, 1.0)    # uncovered live: keep
        amap = torch.where(hit, alpha, 0.0).reshape(Hb, Wb)
        keep = (_max3x3(amap) > tau_cull).reshape(-1)
        hit = hit & keep
        # window refinement to the alpha-bearing interval
        act = sdt > 1e-4
        any_act_c = torch.any(act, -1)
        first = _first_true(act)
        last = K - 1 - _first_true(torch.flip(act, [-1]))
        t_lo_c = torch.gather(ts, 1, first[:, None])[:, 0] - 2.0 * dt
        t_hi_c = torch.gather(ts, 1, last[:, None])[:, 0] + 2.0 * dt
        t_lo_c = torch.where(any_act_c, t_lo_c, t0_c)
        t_hi_c = torch.where(any_act_c, t_hi_c, t1_c)
        t_lo = t0.clone()
        t_lo[bidx] = t_lo_c
        t_hi = t1.clone()
        t_hi[bidx] = t_hi_c
        big = 3.4e38
        active = torch.zeros((nb,), dtype=torch.bool, device=hit.device)
        active[bidx] = any_act_c
        ok = hit & (active | ~covered)
        lo_map = torch.where(ok, t_lo, big).reshape(Hb, Wb)
        hi_map = torch.where(ok, t_hi, -big).reshape(Hb, Wb)
        lo3 = -_max3x3(-lo_map)
        hi3 = _max3x3(hi_map)
        has_nb = (hi3 > -big).reshape(-1)    # any active ray in 3x3 patch
        t0_r = torch.where(has_nb, torch.maximum(t0, lo3.reshape(-1)), t0)
        t1_r = torch.where(has_nb, torch.minimum(t1, hi3.reshape(-1)), t1)
        t0 = t0_r
        t1 = torch.maximum(t1_r, t0_r)
    perm, count = _live_permutation(hit, H=H, W=W, Hb=Hb, Wb=Wb, B=B, nb=nb)
    return perm, count, t0, t1, n_hit


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ds = SyntheticSphereDataset(n_frames=8, H=800, W=800)
    t0 = time.time()
    tr = CurvedTrainer(
        ds, mesh_field.make_state(MeshProjector(
            make_icosphere(4, radius=0.5), device=dev)),
        CurvedFieldConfig(field=MeshFieldConfig(), light_model="SH"),
        RenderConfig(**cs.CURVED_RENDER),
        CurvedTrainConfig(**cs.CURVED_TRAIN), seed=7, device=dev)
    tr.initialize_states(1)
    tr.train(cs.CURVED_TRAIN_STEPS)
    torch.cuda.synchronize()
    print(f"trained {cs.CURVED_TRAIN_STEPS} steps in {time.time() - t0:.1f} "
          f"s", flush=True)
    npose = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    gt = cs.white_gt(ds, npose)
    pool = psnr(tr.render_frame(npose, use_ema=False, parity=True)["image"],
                gt)
    print(f"pool frame at the novel pose: {pool:.2f} dB ({card})")
    capped = renderer._prepass_compact
    for name, extra in SETTINGS:
        tr.rcfg = dataclasses.replace(RenderConfig(**cs.CURVED_RENDER),
                                      **extra)
        for cap, fn in (("capped 4096", capped),
                        ("uncapped", prepass_compact_uncapped)):
            hits = []

            def counted(*a, fn=fn, **kw):
                res = fn(*a, **kw)
                hits.append(int(res[4]))           # hit blocks, pre-carve
                return res

            renderer._prepass_compact = counted
            try:
                out = tr.render_frame(npose, use_ema=False)     # warm-up
                walls = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = tr.render_frame(npose, use_ema=False)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
            finally:
                renderer._prepass_compact = capped
            p = psnr(out["image"], gt)
            print(f"tau cap: live {name}, {cap}: {p:.2f} dB (pool - live "
                  f"{pool - p:+.2f}), hit blocks {hits[-1]}, live rays "
                  f"{out['live']}, chunks "
                  f"{out['chunks']}, {float(np.median(walls)):.2f} ms/frame "
                  f"(median of 3: {', '.join(f'{w:.2f}' for w in walls)}) "
                  f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
