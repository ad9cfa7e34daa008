"""The textured shell's training in both packages on the CPU, in lockstep
over the whole schedule of a profile of ``tests/test_parity_pipeline.py``
(ROADMAP Queue 3, item 1, link (a)).

Stage 1, the coarse NGP: JAX's ``Trainer`` seeded ``PRNGKey(3 + seed)``
marks its untrained cells; the port starts from its params and grid
(``convert.params_from_jax``, ``occupancy_from_jax``).  Every step both
take JAX's draws: JAX's trainer's own sequence (its key splits and its
frame generator), the port the same numbers recomputed from the keys
(``tests/jax_draws.py``); a full grid refresh every 16 steps (the
profile's ``grid_full_updates`` is TrainConfig's default, every one).

Stage 2, the curved field: on ONE template, the JAX NGP's mesh (largest
component, Laplacian smoothing, h_threshold as the pipeline makes them),
JAX's ``CurvedTrainer`` seeded ``PRNGKey(4 + seed)`` after
``initialize_states(1)``; the port from its params, EMA, grid and anchor
table.  Each step is one ``curved_train_step`` on JAX's draws and a
sparse refresh every 16 steps (the trainer's schedule with
``scan_steps`` 1: JAX's scan of 8 steps draws from other keys).

Reported, per stage: every step's loss in both packages and their
relative and absolute differences (a TSV under
``build/shell_lockstep/``), the first step that breaks the lockstep
bounds (the difference <= 1e-2 at each step of the first refresh cycle;
after it <= 0.1 at each step and <= 1e-2 on the mean since the cycle;
relative for the NGP's loss, absolute for the curved loss, whose cosine
term takes it through 0), the held-out PSNR of both at the end, and
the mesh vertex counts of both NGPs.  One JSON line a seed (also
appended to ``build/shell_lockstep/lockstep.jsonl``).

``--control`` runs the same schedule with JAX on both sides, the second
from the init moved by one ulp (every f32 leaf, ``np.nextafter``): how
far the reference parts from itself under the smallest change, the
floor under any port's lockstep over a long schedule.
``--bench_ngp_steps N`` (``--bench_curved_steps N``) runs bench.py's
NGP (curved) arm at full width instead (800x800, ``chip_smoke``'s
configs), N steps, with or without ``--control``.

    python scripts/shell_lockstep.py --profile FULL --seeds 0 1 2
    python scripts/shell_lockstep.py --profile FULL --seeds 0 --control
    python scripts/shell_lockstep.py --bench_ngp_steps 160 [--control]
    python scripts/shell_lockstep.py --bench_curved_steps 96 [--control]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from jax_draws import (curved_batch, curved_grid_noise,  # noqa: E402
                       ngp_batch, ngp_grid_draws)
from nerf_texture_tpu.data.poses import orbit_pose  # noqa: E402
from nerf_texture_tpu.data.synthetic import (  # noqa: E402
    SyntheticShellDataset, render_gt_shell)
from nerf_texture_tpu.geometry import projector as jproj  # noqa: E402
from nerf_texture_tpu.geometry import shape_tools as jst  # noqa: E402
from nerf_texture_tpu.geometry.mesh import Mesh as JaxMesh  # noqa: E402
from nerf_texture_tpu.geometry.projector import (  # noqa: E402
    MeshProjector as JaxMeshProjector)
from nerf_texture_tpu.models import curved_field as jcf  # noqa: E402
from nerf_texture_tpu.models import mesh_field as jmf  # noqa: E402
from nerf_texture_tpu.models import ngp as jngp  # noqa: E402
from nerf_texture_tpu.render import renderer as jr  # noqa: E402
from nerf_texture_tpu.train import curved_trainer as jct  # noqa: E402
from nerf_texture_tpu.train import field_io as jio  # noqa: E402
from nerf_texture_tpu.train import trainer as jt  # noqa: E402
from nerf_texture_tpu_torch.convert import (  # noqa: E402
    occupancy_from_jax, params_from_jax)
from nerf_texture_tpu_torch.data import synthetic as tsyn  # noqa: E402
from nerf_texture_tpu_torch.geometry.mesh import Mesh  # noqa: E402
from nerf_texture_tpu_torch.geometry.projector import (  # noqa: E402
    MeshProjector)
from nerf_texture_tpu_torch.models import curved_field as tcf  # noqa: E402
from nerf_texture_tpu_torch.models import mesh_field as tmf  # noqa: E402
from nerf_texture_tpu_torch.models import ngp as tngp  # noqa: E402
from nerf_texture_tpu_torch.render import renderer as tr  # noqa: E402
from nerf_texture_tpu_torch.train import curved_trainer as tct  # noqa: E402
from nerf_texture_tpu_torch.train import field_io as tio  # noqa: E402
from nerf_texture_tpu_torch.train import trainer as tt  # noqa: E402
from nerf_texture_tpu_torch.utils.metrics import psnr  # noqa: E402
from torch_shell_pipeline import (PROFILES, curved_configs,  # noqa: E402
                                  ngp_configs)

OUT = os.path.join(ROOT, "build", "shell_lockstep")
# the lockstep bounds (tests/test_torch_train.py, PR 5's curved test):
# the loss difference in the first refresh cycle, at any later step, and
# on the mean after the first cycle
FIRST_CYCLE_REL, STEP_REL, MEAN_REL = 1e-2, 0.1, 1e-2


def bounds(losses_j, losses_t, interval: int, relative: bool) -> dict:
    """The loss differences (relative to JAX's loss for the NGP; absolute
    for the curved loss, whose cosine term takes it through 0, as PR 5's
    test bounds it) and the first step (0-based) that breaks the lockstep
    bounds, or None: <= 1e-2 at each step of the first refresh cycle,
    then <= 0.1 at each step and <= 1e-2 on the mean since the cycle."""
    lj, lt = np.asarray(losses_j), np.asarray(losses_t)
    d = np.abs(lt - lj)
    if relative:
        d = d / np.maximum(np.abs(lj), 1e-12)
    first = None
    for i in range(len(d)):
        if i < interval:
            bad = d[i] > FIRST_CYCLE_REL
        else:
            mean = (d[interval:i + 1].mean() if relative else
                    abs(lt[interval:i + 1].mean() - lj[interval:i + 1].mean()))
            bad = d[i] > STEP_REL or mean > MEAN_REL
        if bad:
            first = i
            break
    after = slice(interval, None)
    return {"diff": d, "relative": relative, "first_break": first,
            "max_diff_first_cycle": float(d[:interval].max()),
            "max_diff": float(d.max()),
            "mean_diff_after": float(d[after].mean()) if len(d) > interval
            else 0.0,
            "mean_gap_after": float(lt[after].mean() - lj[after].mean())
            if len(d) > interval else 0.0}


def progress(stage: str, step: int, losses_j, losses_t, every: int = 50):
    if (step + 1) % every == 0:
        print(f"{stage}: step {step + 1}, loss {losses_j[-1]:.6f} (JAX) "
              f"{losses_t[-1]:.6f} (port), {time.strftime('%H:%M:%S')}",
              file=sys.stderr, flush=True)


def write_log(path: str, losses_j, losses_t):
    with open(path, "w") as fh:
        fh.write("step\tloss_jax\tloss_port\trel_diff\tabs_diff\n")
        for i, (a, b) in enumerate(zip(losses_j, losses_t)):
            fh.write(f"{i + 1}\t{a:.9g}\t{b:.9g}\t"
                     f"{abs(b - a) / max(abs(a), 1e-12):.6g}\t"
                     f"{abs(b - a):.6g}\n")


def gt_over_white(ds, pose) -> np.ndarray:
    img = render_gt_shell(pose, ds.intrinsics, ds.H, ds.W, ds.base,
                          ds.bump_amp)
    rgb = img[..., :3].astype(np.float32) / 255.0
    a = img[..., 3:].astype(np.float32) / 255.0
    return rgb * a + (1.0 - a)


def scene(P: dict) -> tuple:
    """(JAX's shell dataset, the port's, the held-out pose, its ground
    truth over white) of tests/test_parity_pipeline.py:79-84."""
    ds = SyntheticShellDataset(n_frames=P["frames"], H=P["H"], W=P["H"])
    dst = tsyn.SyntheticShellDataset(n_frames=P["frames"], H=P["H"],
                                     W=P["H"])
    assert np.array_equal(np.asarray(ds.images), dst.images)
    pose = orbit_pose(np.pi / 2 + 0.25, 1.234, ds.radius)
    return ds, dst, pose, gt_over_white(ds, pose)


def nudged(tree):
    """Every f32 leaf moved by one ulp (towards +inf): the smallest change
    of an init, for the control run."""
    def one(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return jnp.asarray(a)
        return jnp.asarray(np.nextafter(a, np.float32(np.inf)))
    return jax.tree.map(one, tree)


def ngp_lockstep(P: dict, seed: int, ds, dst, pose, gt,
                 steps: int | None = None, control: bool = False,
                 configs: tuple | None = None, key: int | None = None
                 ) -> tuple:
    """Stage 1 in lockstep for ``steps`` steps (the profile's by default;
    the LR schedule is the profile's either way); returns (result dict,
    (JAX's losses, the other side's), JAX's trainer, the port's).  With
    ``control`` the other side is JAX again, from the init ``nudged`` by
    one ulp, on the same draws (the port's trainer is then None).
    ``configs`` (NGP, render, train keywords) and ``key`` (the PRNGKey's
    seed) replace the profile's and 3 + seed."""
    mk, rk, tk = ngp_configs(P) if configs is None else configs
    cfg_j = dict(mcfg=jngp.NGPConfig(**mk), rcfg=jr.RenderConfig(**rk),
                 tcfg=jt.TrainConfig(**tk))
    cfg_t = dict(mcfg=tngp.NGPConfig(**mk), rcfg=tr.RenderConfig(**rk),
                 tcfg=tt.TrainConfig(**tk))
    jtr = jt.Trainer(ds, cfg_j["mcfg"], cfg_j["rcfg"], cfg_j["tcfg"],
                     key=jax.random.PRNGKey(3 + seed if key is None
                                            else key))
    jtr.mark_untrained()
    jstate = jtr.state
    pstate = tt.init_train_state(
        torch.Generator(), cfg_t["mcfg"], cfg_t["rcfg"], cfg_t["tcfg"],
        params=params_from_jax(jax.tree.map(np.asarray, jstate.params),
                               device="cpu"))
    o = jstate.occ
    pstate.occ = occupancy_from_jax(o.density, o.occ, o.mean_density,
                                    o.iter_density, device="cpu")
    if control:
        pstate = jstate._replace(params=nudged(jstate.params),
                                 ema_params=nudged(jstate.ema_params))
    poses, images, intr = (torch.as_tensor(dst.poses),
                           torch.as_tensor(dst.images),
                           torch.as_tensor(dst.intrinsics))
    tcfg = cfg_j["tcfg"]
    H, W = ds.H, ds.W
    grid = rk["grid_size"]
    losses_j, losses_t = [], []
    for step in range(P["ngp_steps"] if steps is None else steps):
        # Trainer.train's sequence: refresh key, frame, step key
        if step % tcfg.grid_update_interval == 0:
            jtr.key, k = jax.random.split(jtr.key)
            full = (step // tcfg.grid_update_interval
                    < tcfg.grid_full_updates)
            jstate = jt.grid_step(jstate, k, mcfg=cfg_j["mcfg"],
                                  rcfg=cfg_j["rcfg"], full=full,
                                  decay=tcfg.grid_decay)
            if control:
                pstate = jt.grid_step(pstate, k, mcfg=cfg_j["mcfg"],
                                      rcfg=cfg_j["rcfg"], full=full,
                                      decay=tcfg.grid_decay)
            else:
                tt.grid_step(pstate, ngp_grid_draws(k, full, grid),
                             mcfg=cfg_t["mcfg"], rcfg=cfg_t["rcfg"],
                             full=full, decay=tcfg.grid_decay)
        frame = jtr._rng.integers(0, ds.num_frames)
        jtr.key, k = jax.random.split(jtr.key)
        # the port's draws first: JAX's step then runs (asynchronously)
        # beside the port's
        batch = None if control else ngp_batch(frame, k, H, W,
                                               tk["num_rays"])
        jstate, mj = jt.train_step(jstate, jtr.poses, jtr.images,
                                   jtr.intrinsics, jnp.asarray(frame), k,
                                   H=H, W=W, **cfg_j)
        if control:
            pstate, mt = jt.train_step(pstate, jtr.poses, jtr.images,
                                       jtr.intrinsics, jnp.asarray(frame),
                                       k, H=H, W=W, **cfg_j)
        else:
            mt = tt.train_step(pstate, batch, poses, images, intr, H=H,
                               W=W, **cfg_t)
        losses_j.append(float(mj["loss"]))
        losses_t.append(float(mt["loss"]))
        progress("ngp", step, losses_j, losses_t)
    ptr = None
    if control:
        jtr.state = pstate
        got = jtr.render_frame(pose, use_ema=False)
    else:
        ptr = tt.Trainer(dst, cfg_t["mcfg"], cfg_t["rcfg"], cfg_t["tcfg"],
                         device="cpu")
        ptr.state = pstate
        with torch.no_grad():
            got = ptr.render_frame(pose, use_ema=False)
    jtr.state = jstate
    want = jtr.render_frame(pose, use_ema=False)
    b = bounds(losses_j, losses_t, tcfg.grid_update_interval, True)
    res = {"psnr_jax": float(psnr(np.asarray(want["image"]), gt)),
           "psnr_port": float(psnr(np.asarray(got["image"]), gt)),
           **{k: v for k, v in b.items() if k != "diff"}}
    return res, (losses_j, losses_t), jtr, ptr


def meshes(P: dict, jtr, ptr, workdir: str) -> tuple:
    """Both NGPs' meshes (vertex counts; the port's without a port
    trainer ``ptr``) and the template, h_threshold and both projectors
    made from JAX's, as the pipeline makes them."""
    mj, pj = jtr.mcfg, jtr.state.params

    def dens_j(p):
        return jngp.density(pj, p, mj)[0]

    kw = dict(resolution=P["mesh_res"], bound=1.0,
              threshold=P["mc_threshold"])
    v, f = jio.save_mesh(dens_j, os.path.join(workdir, "jax.obj"), **kw)
    vt = None
    if ptr is not None:
        @torch.no_grad()
        def dens_t(p):
            return tngp.density(ptr.state.params, p, ptr.mcfg)[0]

        vt, _ = tio.save_mesh(dens_t, os.path.join(workdir, "port.obj"),
                              device="cpu", **kw)
    mesh_raw = jst.keep_largest_component(
        JaxMesh(np.asarray(v, np.float32), np.asarray(f)))
    mesh = jst.laplacian_smooth(mesh_raw, iterations=6)
    mp_j = JaxMeshProjector(mesh)
    vr = mesh_raw.vertices
    pts = jnp.asarray(vr[np.random.default_rng(0).choice(
        len(vr), size=min(2000, len(vr)), replace=False)], jnp.float32)
    sdf = jproj.signed_distance(mp_j.arrays, pts)[0]
    h = max(float(2.0 * jnp.quantile(jnp.abs(sdf), 0.7)),
            2.5 * jtr.dataset.bump_amp)
    mp_t = MeshProjector(Mesh(np.asarray(mesh.vertices, np.float32),
                              np.asarray(mesh.faces)), device="cpu")
    return {"vertices_jax": int(len(v)),
            "vertices_port": None if vt is None else int(len(vt)),
            "template_vertices": int(len(mesh.vertices)), "h": h}, mp_j, mp_t


def curved_lockstep(P: dict, seed: int, ds, dst, mp_j, mp_t, h: float,
                    pose, gt, control: bool = False,
                    configs: tuple | None = None, key: int | None = None,
                    steps: int | None = None) -> tuple:
    """Stage 2 in lockstep on one template; returns (result, losses).
    With ``control`` the other side is JAX from the init ``nudged``.
    ``configs`` (MeshFieldConfig, CurvedFieldConfig extras, train and
    render keywords), ``key`` and ``steps`` replace the profile's, 4 +
    seed and the profile's step count."""
    if configs is None:
        fk, ck, tk = curved_configs(P, h)
        _, rk, _ = ngp_configs(P)
    else:
        fk, ck, tk, rk = configs
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**fk), **ck)
    ct = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**fk), **ck)
    rj = jr.RenderConfig(**rk)        # ray_chunk 1600 already
    rt = tr.RenderConfig(**rk)
    tj_cfg, tt_cfg = jct.CurvedTrainConfig(**tk), tct.CurvedTrainConfig(**tk)
    ctr = jct.CurvedTrainer(ds, jmf.make_state(mp_j), cj, rj, tj_cfg,
                            key=jax.random.PRNGKey(4 + seed if key is None
                                                   else key))
    ctr.initialize_states(1)
    near = ctr._get_near_cells()
    tab_j = ctr._anchor_table()
    tab_t = torch.from_numpy(np.array(tab_j))
    st = tmf.make_state(mp_t)
    jstate = ctr.state
    pstate = tct.init_curved_state(
        torch.Generator(), ct, rt, tt_cfg,
        params=params_from_jax(jax.tree.map(np.asarray, jstate.params),
                               device="cpu"))
    pstate.ema_params = params_from_jax(
        jax.tree.map(np.asarray, jstate.ema_params), device="cpu")
    o = jstate.occ
    pstate.occ = occupancy_from_jax(o.density, o.occ, o.mean_density,
                                    o.iter_density, device="cpu")
    if control:
        pstate = jstate._replace(params=nudged(jstate.params),
                                 ema_params=nudged(jstate.ema_params))
    poses, images, intr = (torch.as_tensor(dst.poses),
                           torch.as_tensor(dst.images),
                           torch.as_tensor(dst.intrinsics))
    H, W = ds.H, ds.W
    rt_t = tmf.FieldRuntime.default()
    step_kw = dict(ccfg=ct, rcfg=rt, tcfg=tt_cfg, H=H, W=W, rt=rt_t,
                   anchor_tab=tab_t)
    interval = tk["grid_update_interval"]
    losses_j, losses_t = [], []
    for step in range(P["curved_steps"] if steps is None else steps):
        if step % interval == 0:
            ctr.key, k = jax.random.split(ctr.key)
            jstate = jct.curved_grid_step(
                jstate, ctr.field_state, k, ccfg=cj, rcfg=rj,
                near_cells=near, anchor_tab=tab_j, rt=ctr.runtime)
            if control:
                pstate = jct.curved_grid_step(
                    pstate, ctr.field_state, k, ccfg=cj, rcfg=rj,
                    near_cells=near, anchor_tab=tab_j, rt=ctr.runtime)
            else:
                view = dataclasses.replace(
                    pstate, params=tct.curved_infer_params(pstate.params,
                                                           ct))
                tct.curved_grid_step(
                    view, st, [torch.from_numpy(curved_grid_noise(
                        k, len(near), rk["grid_size"]))],
                    ccfg=ct, rcfg=rt, near_cells=near, anchor_tab=tab_t,
                    rt=rt_t)
                pstate.occ = view.occ
        frame = int(ctr._rng.integers(0, ds.num_frames))
        ctr.key, k = jax.random.split(ctr.key)
        jstate, mj = jct.curved_train_step(
            jstate, ctr.field_state, ctr.poses, ctr.images, ctr.intrinsics,
            jnp.asarray(frame), k, ccfg=cj, rcfg=rj, tcfg=tj_cfg, H=H, W=W,
            rt=ctr.runtime, anchor_tab=tab_j)
        if control:
            pstate, mt = jct.curved_train_step(
                pstate, ctr.field_state, ctr.poses, ctr.images,
                ctr.intrinsics, jnp.asarray(frame), k, ccfg=cj, rcfg=rj,
                tcfg=tj_cfg, H=H, W=W, rt=ctr.runtime, anchor_tab=tab_j)
        else:
            mt = tct.curved_train_step(
                pstate, curved_batch(k, frame, tt_cfg, rt, H, W, ct.field),
                st, poses, images, intr, **step_kw)
        losses_j.append(float(mj["loss"]))
        losses_t.append(float(mt["loss"]))
        progress("curved", step, losses_j, losses_t)
    if control:
        ctr.state = pstate
        got = ctr.render_frame(pose, use_ema=False)
    else:
        ptr = tct.CurvedTrainer(dst, st, ct, rt, tt_cfg, device="cpu")
        ptr.state = pstate
        ptr._anchor_tab = (st.projector, True, tab_t)
        with torch.no_grad():
            got = ptr.render_frame(pose, use_ema=False)
    ctr.state = jstate
    want = ctr.render_frame(pose, use_ema=False)
    b = bounds(losses_j, losses_t, interval, False)
    res = {"psnr_jax": float(psnr(np.asarray(want["image"]), gt)),
           "psnr_port": float(psnr(np.asarray(got["image"]), gt)),
           **{k: v for k, v in b.items() if k != "diff"}}
    return res, (losses_j, losses_t)


def bench_ngp(steps: int, control: bool = False) -> dict:
    """bench.py's NGP arm at full width (``chip_smoke``'s BENCH_* configs,
    800x800, 8 frames, ``PRNGKey(7)``) in lockstep for ``steps`` steps;
    the held-out PSNR at bench.py's novel pose."""
    import chip_smoke as smoke
    from nerf_texture_tpu.data.synthetic import (SyntheticSphereDataset,
                                                 render_gt_sphere)

    ds = SyntheticSphereDataset(n_frames=8, H=800, W=800)
    dst = tsyn.SyntheticSphereDataset(n_frames=8, H=800, W=800)
    pose = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    gt = render_gt_sphere(pose, ds.intrinsics, 800, 800, 0.5).astype(
        np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    t0 = time.perf_counter()
    res, logs, _, _ = ngp_lockstep(
        None, 0, ds, dst, pose, gt, steps=steps, control=control,
        configs=(smoke.BENCH_NGP, smoke.BENCH_RENDER, smoke.BENCH_TRAIN),
        key=7)
    write_log(os.path.join(OUT, "bench_ngp" + ("_control" if control
                                               else "") + ".tsv"), *logs)
    return {"bench_ngp": res, "steps": steps, "control": control,
            "seconds": time.perf_counter() - t0}


def bench_curved(steps: int, control: bool = False) -> dict:
    """bench.py's curved arm at full width (``chip_smoke``'s CURVED_*
    configs, ``MeshFieldConfig()``, the SH light, ``make_icosphere(4,
    0.5)``, 800x800, ``PRNGKey(7)``, ``initialize_states(1)``) in
    lockstep for ``steps`` steps; the live PSNR at bench.py's novel
    pose."""
    import chip_smoke as smoke
    from nerf_texture_tpu.data.synthetic import (SyntheticSphereDataset,
                                                 render_gt_sphere)
    from nerf_texture_tpu.geometry.mesh import make_icosphere as jico
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere

    ds = SyntheticSphereDataset(n_frames=8, H=800, W=800)
    dst = tsyn.SyntheticSphereDataset(n_frames=8, H=800, W=800)
    pose = orbit_pose(np.pi / 2 + 0.2, 0.3, ds.radius)
    gt = render_gt_sphere(pose, ds.intrinsics, 800, 800, 0.5).astype(
        np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    t0 = time.perf_counter()
    res, logs = curved_lockstep(
        None, 0, ds, dst, JaxMeshProjector(jico(4, radius=0.5)),
        MeshProjector(make_icosphere(4, radius=0.5), device="cpu"), 0.0,
        pose, gt, control=control, key=7, steps=steps,
        configs=({}, dict(light_model="SH"), smoke.CURVED_TRAIN,
                 smoke.CURVED_RENDER))
    write_log(os.path.join(OUT, "bench_curved" + ("_control" if control
                                                  else "") + ".tsv"), *logs)
    return {"bench_curved": res, "steps": steps, "control": control,
            "seconds": time.perf_counter() - t0}


def run(profile: str, seed: int, control: bool = False) -> dict:
    P = PROFILES[profile]
    ds, dst, pose, gt = scene(P)
    res = {"profile": profile, "seed": seed, "control": control,
           "seconds": {}}
    tag = f"{profile}_seed{seed}" + ("_control" if control else "")
    t0 = time.perf_counter()
    ngp, logs, jtr, ptr = ngp_lockstep(P, seed, ds, dst, pose, gt,
                                       control=control)
    write_log(os.path.join(OUT, f"{tag}_ngp.tsv"), *logs)
    res["ngp"] = ngp
    res["seconds"]["ngp"] = time.perf_counter() - t0
    print(json.dumps({"seed": seed, "ngp": ngp}), flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        res["mesh"], mp_j, mp_t = meshes(P, jtr, ptr, work)
    res["seconds"]["mesh"] = time.perf_counter() - t0
    print(json.dumps({"seed": seed, "mesh": res["mesh"]}), flush=True)
    t0 = time.perf_counter()
    curved, logs = curved_lockstep(P, seed, ds, dst, mp_j, mp_t,
                                   res["mesh"]["h"], pose, gt,
                                   control=control)
    write_log(os.path.join(OUT, f"{tag}_curved.tsv"), *logs)
    res["curved"] = curved
    res["seconds"]["curved"] = time.perf_counter() - t0
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", choices=sorted(PROFILES), default="FULL")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--control", action="store_true",
                    help="JAX against JAX from an init nudged by one ulp "
                         "(the reference's own sensitivity), no port")
    ap.add_argument("--bench_ngp_steps", type=int, default=0,
                    help="instead of the shell: bench.py's NGP arm at "
                         "full width for this many steps")
    ap.add_argument("--bench_curved_steps", type=int, default=0,
                    help="instead of the shell: bench.py's curved arm at "
                         "full width for this many steps")
    args = ap.parse_args()
    # two torch threads: JAX's thread pools share the process
    torch.set_num_threads(2)
    os.makedirs(OUT, exist_ok=True)
    if args.bench_ngp_steps or args.bench_curved_steps:
        row = (bench_ngp(args.bench_ngp_steps, args.control)
               if args.bench_ngp_steps
               else bench_curved(args.bench_curved_steps, args.control))
        print(json.dumps(row), flush=True)
        with open(os.path.join(OUT, "lockstep.jsonl"), "a") as fh:
            fh.write(json.dumps(row) + "\n")
        return
    for seed in args.seeds:
        row = run(args.profile, seed, args.control)
        print(json.dumps(row), flush=True)
        with open(os.path.join(OUT, "lockstep.jsonl"), "a") as fh:
            fh.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
