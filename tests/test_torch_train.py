"""NGP training in the PyTorch port vs the JAX package: the pool-path
render and its gradients, one train step, the optimizer, the grid
refresh, and a short training run in lockstep.

The port draws its random numbers from a torch.Generator, JAX from its
keys; so every comparison hands the port the draws JAX made (pixel
indices, march jitter, background, grid jitter), recomputed here from the
same keys the JAX functions split.

Tolerances, each with its reason:
- mark_untrained, occupancy masks and draws exactly;
- the optimizer (Adam, LR decay, EMA) on given gradients within 1e-6
  relative: the same formula in f64 (PyTorch) and f32 (optax) scalars;
- densities of a grid refresh within 1e-5 relative for all but <= 1% of
  the cells: the field reads bf16 table rows and bf16 MLP activations on
  both sides, so a last-bit difference in an f32 sum can round an
  activation to the neighbouring bf16 value (then up to 1e-2);
- a render's image within 2e-3 and its loss within 1e-3 relative (the
  same bf16 rounding, composited);
- gradients within 5e-2 of each leaf's largest entry: the cotangents of
  the bf16 table rows and MLP activations are rounded to bf16 on both
  sides, from f32 values that may differ in the last bit;
- the lockstep run: the loss within 1% of JAX's at every step (measured:
  at most 7.7e-4 relative over 30 steps; Adam with eps 1e-15 turns each
  near-zero gradient into a step of +-lr, so a gradient whose sign
  differs by rounding moves a table entry by 2 lr and the runs drift
  apart slowly), and the held-out PSNR within 0.3 dB (ROADMAP's bound
  for trained models).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_texture_tpu.data.rays import get_rays as jax_get_rays
from nerf_texture_tpu.data.rays import sample_ray_indices as jax_sample
from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.ops import occupancy as jocc
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train import trainer as jt
from nerf_texture_tpu_torch.convert import occupancy_from_jax, params_from_jax
from nerf_texture_tpu_torch.data.poses import orbit_pose
from nerf_texture_tpu_torch.data.synthetic import render_gt_sphere
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.ops import occupancy as tocc
from nerf_texture_tpu_torch.render import renderer as tr
from nerf_texture_tpu_torch.train import trainer as tt
from nerf_texture_tpu_torch.utils.metrics import psnr

H = W = 32
GRID = 16
NGP_KW = dict(bound=1.0, num_levels=4, level_dim=4, log2_bricks=10,
              desired_resolution=256)
RENDER_KW = dict(bound=1.0, cascades=1, grid_size=GRID, max_steps=64,
                 max_samples_train=32, ray_chunk=1024, pool_mean_samples=16,
                 proxy_samples=0, proxy_refined=24, infer_color_cap=4,
                 prepass_block=4, prepass_tau_cull=0.1)
TRAIN_KW = dict(lr=1e-2, total_steps=200, num_rays=256, grid_decay=0.85)
CFG_J = dict(mcfg=jngp.NGPConfig(**NGP_KW), rcfg=jr.RenderConfig(**RENDER_KW),
             tcfg=jt.TrainConfig(**TRAIN_KW))
CFG_T = dict(mcfg=tngp.NGPConfig(**NGP_KW), rcfg=tr.RenderConfig(**RENDER_KW),
             tcfg=tt.TrainConfig(**TRAIN_KW))


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.fixture(scope="module")
def scene():
    ds = SyntheticSphereDataset(n_frames=8, H=H, W=W)
    return ds, dict(poses=_t(ds.poses), images=_t(ds.images),
                    intrinsics=_t(ds.intrinsics))


def _jax_state(scene, seed=0):
    """A fresh JAX train state with the cameras' untrained cells marked."""
    ds, _ = scene
    st = jt._init_train_state(jax.random.PRNGKey(seed), **CFG_J)
    occ = jocc.mark_untrained(st.occ, jnp.asarray(ds.poses),
                              jnp.asarray(ds.intrinsics), grid_size=GRID,
                              cascades=1, bound=1.0)
    return st._replace(occ=occ)


def _port_state(jstate):
    """The port's state holding the JAX state's params and grid."""
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                             device="cpu")
    st = tt.init_train_state(torch.Generator(), CFG_T["mcfg"], CFG_T["rcfg"],
                             CFG_T["tcfg"], params=params)
    o = jstate.occ
    st.occ = occupancy_from_jax(o.density, o.occ, o.mean_density,
                                o.iter_density, device="cpu")
    return st


def _grid_draws(key, full):
    """The draws JAX's occupancy.update takes from ``key`` (one cascade)."""
    half = 1.0 / GRID
    n = GRID ** 3 // 4
    if full:
        k1, _ = jax.random.split(key)
        noise = jax.random.uniform(k1, (GRID ** 3, 3), minval=-half,
                                   maxval=half)
        return [tocc.GridDraws(noise=_t(noise))]
    k1, k2, k3, _ = jax.random.split(key, 4)
    return [tocc.GridDraws(
        noise=_t(jax.random.uniform(k3, (2 * n, 3), minval=-half,
                                    maxval=half)),
        cells=_t(jax.random.randint(k1, (n,), 0, GRID ** 3), torch.int64),
        keys=_t(jax.random.uniform(k2, (GRID ** 3,))))]


def _batch(frame, key):
    """The draws JAX's train_step takes from ``key``, as a port Batch."""
    k_pix, k_perturb, k_bg = jax.random.split(key, 3)
    n = TRAIN_KW["num_rays"]
    inds, _ = jax_sample(k_pix, H, W, n)
    return tt.Batch(frame=torch.tensor(int(frame)),
                    inds=_t(inds, torch.int64),
                    u=_t(jax.random.uniform(k_perturb, (n,), jnp.float32)),
                    bg=_t(jax.random.uniform(k_bg, (3,))))


def _leaves_close(got, want, rel):
    """Each leaf within rel of its largest entry (see the docstring)."""
    gl = tt.param_leaves(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()))


def _grid_close(got, want):
    d_t, d_j = _np(got.density), np.asarray(want.density)
    off = np.abs(d_t - d_j) > 1e-5 * np.abs(d_j) + 1e-7
    assert off.mean() <= 0.01, off.mean()
    np.testing.assert_allclose(d_t, d_j, rtol=1e-2, atol=1e-6)
    occ_t, occ_j = _np(got.occ), np.asarray(want.occ)
    assert np.mean(occ_t != occ_j) <= 0.01
    assert 0 < occ_j.mean() < 1
    np.testing.assert_allclose(float(got.mean_density),
                               float(want.mean_density), rtol=1e-4)
    assert int(got.iter_density) == int(want.iter_density)


def test_mark_untrained_matches(scene):
    ds, sc = scene
    fresh = jocc.create(GRID, 1)
    # two cameras: eight on the orbit see every cell
    want = jocc.mark_untrained(fresh, jnp.asarray(ds.poses[:2]),
                               jnp.asarray(ds.intrinsics), grid_size=GRID,
                               cascades=1, bound=1.0)
    got = tocc.mark_untrained(tocc.create(GRID, 1, device="cpu"),
                              sc["poses"][:2], sc["intrinsics"],
                              grid_size=GRID, cascades=1, bound=1.0)
    d = np.asarray(want.density)
    assert 0 < (d < 0).mean() < 1
    np.testing.assert_array_equal(_np(got.density), d)


def test_grid_refresh_full_then_partial_matches(scene):
    jstate = _jax_state(scene)
    # a table scaled so that sigma varies, and a threshold it crosses
    jstate = jstate._replace(params={**jstate.params,
                                     "grid": jstate.params["grid"] * 3e3})
    rj = dataclasses.replace(CFG_J["rcfg"], density_thresh=1.0)
    rt = dataclasses.replace(CFG_T["rcfg"], density_thresh=1.0)
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    jfull = jt.grid_step(jstate, k1, mcfg=CFG_J["mcfg"], rcfg=rj, full=True,
                         decay=0.85)
    pstate = _port_state(jstate)
    tt.grid_step(pstate, _grid_draws(k1, True), mcfg=CFG_T["mcfg"], rcfg=rt,
                 full=True, decay=0.85)
    _grid_close(pstate.occ, jfull.occ)
    # partial refresh from the same (JAX) grid on both sides
    jpart = jt.grid_step(jfull, k2, mcfg=CFG_J["mcfg"], rcfg=rj, full=False,
                         decay=0.85)
    pstate = _port_state(jfull)
    tt.grid_step(pstate, _grid_draws(k2, False), mcfg=CFG_T["mcfg"],
                 rcfg=rt, full=False, decay=0.85)
    _grid_close(pstate.occ, jpart.occ)
    changed = np.asarray(jpart.occ.density) != np.asarray(jfull.occ.density)
    assert 0.1 < changed.mean() < 0.6      # a partial refresh


def test_render_rays_pool_path_matches_with_gradients(scene):
    ds, _ = scene
    jstate = _jax_state(scene, seed=1)
    params = jax.tree.map(np.asarray, jstate.params)
    params["grid"] = params["grid"] * 1e3        # sigma and colour vary
    rng = np.random.default_rng(3)
    inds = rng.integers(0, H * W, 200)
    rays = jax_get_rays(jnp.asarray(ds.poses[2]), jnp.asarray(ds.intrinsics),
                        H, W, jnp.asarray(inds))
    occ = (rng.uniform(size=GRID ** 3) < 0.7).astype(np.uint8)
    target = rng.uniform(size=(200, 3)).astype(np.float32)
    bg = np.array([0.3, 0.6, 0.9], np.float32)
    mj, rj = CFG_J["mcfg"], CFG_J["rcfg"]

    def loss_j(p):
        out = jr.render_rays(lambda x, d: jngp.forward(p, x, d, mj),
                             jnp.asarray(occ), rays["rays_o"],
                             rays["rays_d"], rj, max_samples=32,
                             bg_color=jnp.asarray(bg))
        return jnp.mean((out["image"] - target) ** 2), out

    (lj, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    pt = jax.tree.map(lambda a: a, params_from_jax(params, device="cpu"))
    for leaf in tt.param_leaves(pt):
        leaf.requires_grad_(True)
    out_t = tr.render_rays(
        lambda x, d: tngp.forward(pt, x, d, CFG_T["mcfg"]), _t(occ),
        _t(rays["rays_o"]), _t(rays["rays_d"]), CFG_T["rcfg"],
        max_samples=32, bg_color=_t(bg))
    lt = torch.mean((out_t["image"] - _t(target)) ** 2)
    lt.backward()
    # the pool decimates (32 march slots, 16 pool slots a ray)
    assert int(np.asarray(out_j["counts"]).max()) > 16
    np.testing.assert_array_equal(_np(out_t["counts"]),
                                  np.asarray(out_j["counts"]))
    np.testing.assert_allclose(_np(out_t["image"]),
                               np.asarray(out_j["image"]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(_np(out_t["weights_sum"]),
                               np.asarray(out_j["weights_sum"]), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-3)
    _leaves_close([p.grad for p in tt.param_leaves(pt)], g_j, 5e-2)


def test_one_train_step_matches(scene):
    ds, sc = scene
    jstate = _jax_state(scene, seed=2)
    kg, ks = jax.random.split(jax.random.PRNGKey(5))
    jstate = jt.grid_step(jstate, kg, mcfg=CFG_J["mcfg"], rcfg=CFG_J["rcfg"],
                          full=True, decay=0.85)
    frame = 3
    _, metrics = jt.train_step(jstate, jnp.asarray(ds.poses),
                               jnp.asarray(ds.images),
                               jnp.asarray(ds.intrinsics), jnp.asarray(frame),
                               ks, H=H, W=W, **CFG_J)
    # the same loss rebuilt from the draws, for its gradients
    batch = _batch(frame, ks)
    k_perturb = jax.random.split(ks, 3)[1]
    rays = jax_get_rays(jnp.asarray(ds.poses[frame]),
                        jnp.asarray(ds.intrinsics), H, W,
                        jnp.asarray(_np(batch.inds)))
    pix = (jnp.asarray(ds.images[frame]).reshape(H * W, -1)[
        jnp.asarray(_np(batch.inds))].astype(jnp.float32) / 255.0)
    bg = jnp.asarray(_np(batch.bg))
    gt = pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])

    def loss_j(p):
        out = jr.render_rays(lambda x, d: jngp.forward(p, x, d,
                                                       CFG_J["mcfg"]),
                             jstate.occ.occ, rays["rays_o"], rays["rays_d"],
                             CFG_J["rcfg"], max_samples=32, key=k_perturb,
                             perturb=True, bg_color=bg)
        return jnp.mean((out["image"] - gt) ** 2)

    lj, g_j = jax.value_and_grad(loss_j)(jstate.params)
    np.testing.assert_allclose(float(lj), float(metrics["loss"]), rtol=1e-6)
    pstate = _port_state(jstate)
    lt, _ = tt.train_loss(pstate.params, pstate.occ, batch, sc["poses"],
                          sc["images"], sc["intrinsics"], mcfg=CFG_T["mcfg"],
                          rcfg=CFG_T["rcfg"], H=H, W=W)
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-3)
    _leaves_close([p.grad for p in tt.param_leaves(pstate.params)], g_j,
                  5e-2)
    # the whole step runs, and counts
    pstate.optimizer.zero_grad(set_to_none=True)
    m = tt.train_step(pstate, batch, sc["poses"], sc["images"],
                      sc["intrinsics"], H=H, W=W, **CFG_T)
    assert pstate.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(lj), rtol=1e-3)


def test_adam_ema_and_lr_decay_match_optax():
    tcfg_j = jt.TrainConfig(lr=1e-2, total_steps=3, ema_decay=0.9)
    tcfg_t = tt.TrainConfig(lr=1e-2, total_steps=3, ema_decay=0.9)
    rng = np.random.default_rng(0)
    params = {"grid": rng.normal(size=(6, 4)).astype(np.float32),
              "net": [{"w": rng.normal(size=(4, 3)).astype(np.float32)}]}
    opt = jt.make_optimizer(tcfg_j)
    pj = jax.tree.map(jnp.asarray, params)
    opt_state, ema_j = opt.init(pj), pj
    pt = params_from_jax(params, device="cpu")
    for leaf in tt.param_leaves(pt):
        leaf.requires_grad_(True)
    o, s = tt.make_optimizer(pt, tcfg_t)
    state = tt.TrainState(params=pt, optimizer=o, scheduler=s,
                          ema_params=params_from_jax(params, device="cpu"),
                          occ=None)
    for step in range(5):                     # past total_steps: lr floor
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32) * (rng.uniform(size=a.shape) < 0.8), params)
        upd, opt_state = opt.update(jax.tree.map(jnp.asarray, g), opt_state,
                                    pj)
        pj = optax.apply_updates(pj, upd)
        ema_j = jax.tree.map(lambda e, p: e * 0.9 + p * 0.1, ema_j, pj)
        for leaf, gl in zip(tt.param_leaves(pt), jax.tree.leaves(g)):
            leaf.grad = _t(gl)
        lr_used = state.optimizer.param_groups[0]["lr"]
        tt.apply_gradients(state, tcfg_t)
        np.testing.assert_allclose(
            lr_used, 1e-2 * 0.1 ** (min(step, 3) / 3), rtol=1e-12)
        for a, b in ((state.params, pj), (state.ema_params, ema_j)):
            for x, y in zip(tt.param_leaves(a), jax.tree.leaves(b)):
                np.testing.assert_allclose(_np(x), np.asarray(y), rtol=1e-6,
                                           atol=1e-7)
    assert state.step == 5


def _heldout_psnr(params_t, params_j, occ_t, occ_j):
    pose = orbit_pose(np.pi / 2 + 0.2, 0.3, 2.0)
    ds = SyntheticSphereDataset(n_frames=8, H=H, W=W)
    gt = render_gt_sphere(pose, ds.intrinsics, H, W, 0.5).astype(
        np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    got = tt.render_frame(params_t, occ_t, pose, ds.intrinsics, H, W,
                          CFG_T["mcfg"], CFG_T["rcfg"])
    want = jr.render_image(jt.ngp_field_apply, CFG_J["mcfg"], params_j,
                           occ_j.occ, pose, ds.intrinsics, H, W,
                           CFG_J["rcfg"], density=occ_j.density)
    return psnr(got["image"], gt), psnr(np.asarray(want["image"]), gt)


def test_training_in_lockstep_with_jax(scene):
    ds, sc = scene
    jtr = jt.Trainer(ds, CFG_J["mcfg"], CFG_J["rcfg"], CFG_J["tcfg"],
                     key=jax.random.PRNGKey(3))
    jtr.mark_untrained()
    jstate, key = jtr.state, jtr.key
    pstate = _port_state(jstate)
    rng = np.random.default_rng(0)
    data = (jnp.asarray(ds.poses), jnp.asarray(ds.images),
            jnp.asarray(ds.intrinsics))
    losses_j, losses_t = [], []
    for step in range(30):
        if step % 16 == 0:                    # two full grid refreshes
            key, k = jax.random.split(key)
            jstate = jt.grid_step(jstate, k, mcfg=CFG_J["mcfg"],
                                  rcfg=CFG_J["rcfg"], full=True, decay=0.85)
            tt.grid_step(pstate, _grid_draws(k, True), mcfg=CFG_T["mcfg"],
                         rcfg=CFG_T["rcfg"], full=True, decay=0.85)
        frame = rng.integers(0, ds.num_frames)
        key, k = jax.random.split(key)
        jstate, mj = jt.train_step(jstate, *data, jnp.asarray(frame), k, H=H,
                                   W=W, **CFG_J)
        mt = tt.train_step(pstate, _batch(frame, k), sc["poses"],
                           sc["images"], sc["intrinsics"], H=H, W=W, **CFG_T)
        losses_j.append(float(mj["loss"]))
        losses_t.append(float(mt["loss"]))
    losses_j, losses_t = np.asarray(losses_j), np.asarray(losses_t)
    assert losses_j[-5:].mean() < 0.5 * losses_j[:5].mean()   # it learns
    np.testing.assert_allclose(losses_t[0], losses_j[0], rtol=1e-3)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-2)
    p_t, p_j = _heldout_psnr(pstate.params, jstate.params, pstate.occ,
                             jstate.occ)
    assert abs(p_t - p_j) <= 0.3, (p_t, p_j)
    assert p_j > 10.0
