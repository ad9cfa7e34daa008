"""Curved training in the PyTorch port vs the JAX package: the
regularisers (clustering, Lipschitz, KL), the training forward with its
-grad(sigma) normal target, one train step's loss and gradients, a
lockstep run across grid refreshes with its held-out live and pool PSNR,
and the inference tables after a step.

Small width: the configs of ``tests/test_curved_trainer.py`` with
``clustering=True`` (so the regulariser runs) and the single-round proxy,
``make_icosphere(2, 0.5)``, 32x32 frames.  The port takes its draws as
arguments; every comparison hands it the draws JAX made, recomputed here
from the keys the JAX functions split (pixels, march jitter, background,
feature noise, the clustering level).

Tolerances, each with its reason:
- the regularisers: 1e-6 relative (the same f32 formulas; sums in
  another order);
- the training forward: sigma rtol + atol 1e-2, colours and fine normals
  1e-2 (the field bounds of tests/test_torch_curved_field.py: bf16 table
  rows and activations can round to the neighbouring value after a
  last-bit difference); the shell mask,
  and with it which -grad(sigma) rows are finite, exact; the -grad(sigma)
  target by direction, cosine >= 1 - 1e-4 on >= 99% of rows (its
  cotangent passes the bf16 lattice weights on both sides);
- one step: the loss within 1e-3 relative, each parameter leaf's
  gradient within 5e-2 of the leaf's largest entry (the bound of
  tests/test_torch_train.py: bf16 cotangents of the table rows);
- lockstep: the loss within 1e-2 at every step of the first refresh
  cycle, within 0.1 at every step, and its mean over the run within
  1e-2.  The states part in the last bits from the first step (Adam with
  eps 1e-15 turns a near-zero gradient whose sign differs by rounding
  into a step of 2 lr), and the cosine loss counts every ray with a
  finite, non-zero composited target fully: on a ray whose front and
  back shell crossings nearly cancel, the target's direction flips under
  such a change (up to 1.8 / 64 of loss a ray).  More rays a step do
  not close it (measured: 512 rays still part by 0.022 at one step).
  The held-out live and pool PSNR within 0.3 dB (ROADMAP's bound for
  trained models).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.data.rays import get_rays as jax_get_rays
from nerf_texture_tpu.data.rays import sample_ray_indices as jax_sample
from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu.geometry.mesh import make_icosphere as jax_icosphere
from nerf_texture_tpu.geometry.projector import (
    MeshProjector as JaxMeshProjector)
from nerf_texture_tpu.geometry.projector import (
    anchor_frames_from_table as jax_frames_from_table)
from nerf_texture_tpu.models import clustering as jclus
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.models import normal_net as jnn
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu_torch.convert import occupancy_from_jax, params_from_jax
from nerf_texture_tpu_torch.data import synthetic as tsyn
from nerf_texture_tpu_torch.data.poses import orbit_pose
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
from nerf_texture_tpu_torch.geometry.projector import (
    MeshProjector, anchor_frames_from_table)
from nerf_texture_tpu_torch.models import clustering as tclus
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.models import normal_net as tnn
from nerf_texture_tpu_torch.ops import occupancy as tocc
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train import curved_trainer as tct
from nerf_texture_tpu_torch.utils.metrics import psnr

FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=True)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
RENDER = dict(bound=1.0, cascades=1, grid_size=16, max_steps=48,
              max_samples_train=24, max_samples_infer=32, ray_chunk=256,
              pool_mean_samples=16, pool_mean_samples_infer=16,
              proxy_samples=0)
TRAIN = dict(lr=5e-3, total_steps=200, num_rays=64, grid_update_interval=8,
             grid_full_updates=4)
HW = 32
L = FIELD["num_levels"]


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _configs():
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**FIELD), **MODEL)
    ct = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**FIELD), **MODEL)
    rj = jr.RenderConfig(**RENDER)
    return (cj, ct, rj, RenderConfig(**dataclasses.asdict(rj)),
            jct.CurvedTrainConfig(**TRAIN), tct.CurvedTrainConfig(**TRAIN))


def _flat(tree, prefix=()):
    """{path: numpy leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat(tree[k],
                                                     prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree)
                for p, v in _flat(x, prefix + (i,)).items()}
    return {prefix: _np(tree)}


@pytest.fixture(scope="module")
def setup():
    return _make_setup()


def _make_setup():
    """A JAX CurvedTrainer after one grid refresh; the port's field state,
    JAX's anchor table converted, and JAX's params as numpy."""
    cj, ct, rj, rt, tj_cfg, tt_cfg = _configs()
    ds = SyntheticSphereDataset(n_frames=4, H=HW, W=HW)
    tj = jct.CurvedTrainer(ds, jmf.make_state(JaxMeshProjector(
        jax_icosphere(2, radius=0.5))), cj, rj, tj_cfg,
        key=jax.random.PRNGKey(0))
    tj.initialize_states(1)
    tab_j = tj._anchor_table()
    st = tmf.make_state(MeshProjector(make_icosphere(2, radius=0.5),
                                      device="cpu"))
    return dict(cj=cj, ct=ct, rj=rj, rt=rt, tj_cfg=tj_cfg, tt_cfg=tt_cfg,
                ds=ds, tj=tj, tab_j=tab_j, tab_t=torch.from_numpy(
                    np.array(tab_j)), st=st,
                p=jax.tree.map(np.array, tj.state.params))


def _scaled(p, cfg):
    """Params whose features and fine normals matter: the encoder's mean
    lanes x 1e4, the phi grid x 1e3 (and the cluster centres x 1e4, to
    the features' scale)."""
    p = jax.tree.map(np.array, p)
    rw = cfg.field.feature_spec.row_width
    p["field"]["encoder"][:, :rw] *= 1e4
    p["field"]["normal"]["phi_grid"] *= 1e3
    p["field"]["clusters"] *= 1e4
    for net in ("phi_net", "theta_net"):
        for i, lyr in enumerate(p["field"]["normal"][net]):
            lyr["c"] = np.asarray(lyr["c"] + 0.25 * i, np.float32)
    return p


def _rel(a, b, rtol):
    a = a.detach() if torch.is_tensor(a) else a
    np.testing.assert_allclose(float(a), float(b), rtol=rtol, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_regularisers_match_jax(setup, seed):
    cj, ct = setup["cj"], setup["ct"]
    p = _scaled(setup["p"], cj)
    rng = np.random.default_rng(seed)
    # log-variance lanes that vary (the init holds them at ~-8)
    rw = cj.field.feature_spec.row_width
    p["field"]["encoder"][:, rw:] = rng.normal(
        -2.0, 1.0, p["field"]["encoder"][:, rw:].shape).astype(np.float32)
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_jax(p, device="cpu")
    key = jax.random.PRNGKey(seed)
    level = int(jax.random.randint(key, (), 0, L))
    assert 0 <= level < L
    want = jmf.clustering_loss(pj["field"], cj.field, key=key)
    got = tmf.clustering_loss(pt["field"], ct.field, level)
    assert float(want) > 0
    _rel(got, want, 1e-6)
    _rel(tmf.clustering_loss(pt["field"], ct.field),
         jmf.clustering_loss(pj["field"], cj.field), 1e-6)
    # the level functions on raw points
    emb = rng.normal(size=(500, 2)).astype(np.float32)
    cen = rng.normal(size=(4, 2)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tclus.soft_assignment(_t(emb), _t(cen))),
        np.asarray(jclus.soft_assignment(jnp.asarray(emb), jnp.asarray(cen))),
        rtol=1e-6, atol=1e-7)
    _rel(tclus.clustering_loss_level(_t(emb), _t(cen)),
         jclus.clustering_loss_level(jnp.asarray(emb), jnp.asarray(cen)),
         1e-6)
    nj, nt = pj["field"]["normal"], pt["field"]["normal"]
    _rel(tnn.lip_regularization(nt["phi_net"]),
         jnn.lip_regularization(nj["phi_net"]), 1e-6)
    _rel(tnn.regularization(nt), jnn.regularization(nj), 1e-6)
    for normal in (False, True):
        _rel(tmf.kl_loss(pt["field"], ct.field, normal),
             jmf.kl_loss(pj["field"], cj.field, normal), 1e-6)
    _rel(tmf.regular_loss(pt["field"], ct.field, level),
         jmf.regular_loss(pj["field"], cj.field, key=key), 1e-6)
    _rel(tcf.regular_loss(pt, ct, 0, level=level),
         jcf.regular_loss(pj, cj, 0, key=key), 1e-6)


def test_regulariser_switches(setup):
    ct = setup["ct"]
    pt = params_from_jax(setup["p"], device="cpu")
    off = dataclasses.replace(ct.field, clustering=False, prob_model=False)
    assert tmf.clustering_loss(pt["field"], off, 1) == 0.0
    assert tmf.kl_loss(pt["field"], off) == 0.0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcf.regular_loss(pt, ct, 0, optimize_camera_loss=torch.zeros(()))
    # without the Lipschitz net only the field's term is left
    no_lip = dataclasses.replace(ct, field=dataclasses.replace(ct.field,
                                                               lip=False))
    _rel(tcf.regular_loss(pt, no_lip, 0, level=1),
         tmf.regular_loss(pt["field"], ct.field, 1), 1e-7)


def _points(setup, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = (d * (0.5 + rng.uniform(-0.15, 0.15, (n, 1)))).astype(np.float32)
    valid = rng.uniform(size=n) < 0.95
    v = rng.normal(size=(n, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    fj = jax_frames_from_table(setup["tab_j"], jnp.asarray(x),
                               jnp.asarray(valid), 1.0)
    ft = anchor_frames_from_table(setup["tab_t"], _t(x), _t(valid), 1.0)
    return x, v, fj, ft


def test_training_forward_matches_jax(setup):
    cj, ct = setup["cj"], setup["ct"]
    p = _scaled(setup["p"], cj)
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_jax(p, device="cpu")
    x, v, fj, ft = _points(setup)
    key = jax.random.PRNGKey(4)
    rt_j = jmf.FieldRuntime.default()
    s_j, c_j, ex_j = jax.jit(lambda p_, x_, v_, f_: jcf.forward(
        p_, setup["tj"].field_state, x_, v_, cj, rt_j, key=key,
        training=True, frames=f_))(pj, jnp.asarray(x), jnp.asarray(v), fj)
    noise = _t(jax.random.normal(key, (len(x), L * FIELD["level_dim"])))
    s_t, c_t, ex_t = tcf.forward(pt, setup["st"], _t(x), _t(v), ct,
                                 tmf.FieldRuntime.default(), noise=noise,
                                 training=True, frames=ft)
    assert set(ex_t) == set(ex_j) == {"normal", "normal_grad"}
    s_j = np.asarray(s_j)
    # the shell mask (with the finite test of the target) exactly
    np.testing.assert_array_equal(_np(s_t) > 0, s_j > 0)
    assert 0.3 < (s_j > 0).mean() < 1.0
    np.testing.assert_allclose(_np(s_t), s_j, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(c_t), np.asarray(c_j), rtol=0, atol=1e-2)
    assert np.asarray(c_j).std() > 1e-2
    np.testing.assert_allclose(_np(ex_t["normal"]),
                               np.asarray(ex_j["normal"]), rtol=0, atol=1e-2)
    g_t, g_j = _np(ex_t["normal_grad"]), np.asarray(ex_j["normal_grad"])
    fin_t, fin_j = np.isfinite(g_t).all(-1), np.isfinite(g_j).all(-1)
    np.testing.assert_array_equal(fin_t, fin_j)
    # rows the isfinite mask drops: none on this field
    assert int((~fin_j).sum()) == 0
    cos = np.sum(g_t * g_j, -1) / (np.linalg.norm(g_t, axis=-1)
                                   * np.linalg.norm(g_j, axis=-1) + 1e-12)
    assert np.mean(cos[fin_j] >= 1 - 1e-4) >= 0.99, np.sort(cos)[:10]
    # the target is no longer the coarse normal: -grad(sigma) moved it
    assert np.mean(np.abs(g_j - np.asarray(fj["normal"]))) > 1e-3
    # the noise is part of the forward: a draw of another size raises
    with pytest.raises(ValueError, match="noise"):
        tcf.forward(pt, setup["st"], _t(x), _t(v), ct, noise=noise[:10],
                    training=True, frames=ft)


def _jax_keys(key):
    return jax.random.split(key, 5)


def _batch(key, frame, tcfg):
    """The draws JAX's train step takes from ``key``, as a CurvedBatch."""
    k_pix, k_perturb, k_bg, k_noise, k_reg = _jax_keys(key)
    n = tcfg.num_rays
    inds, _ = jax_sample(k_pix, HW, HW, n)
    rows = tct.noise_rows(RenderConfig(**RENDER), n)
    return tct.CurvedBatch(
        frame=torch.tensor(int(frame)), inds=_t(inds, torch.int64),
        u=_t(jax.random.uniform(k_perturb, (n,), jnp.float32)),
        bg=_t(jax.random.uniform(k_bg, (n, 3))),
        noise=_t(jax.random.normal(k_noise, (rows, L * FIELD["level_dim"]))),
        level=int(jax.random.randint(k_reg, (), 0, L)))


def _jax_loss(params, jstate, tj, frame, key, cj, rj, tcfg):
    """The loss of JAX's ``_curved_train_step_body`` rebuilt from its
    pieces (the same keys), for its gradients."""
    k_pix, k_perturb, k_bg, k_noise, k_reg = _jax_keys(key)
    inds, _ = jax_sample(k_pix, HW, HW, tcfg.num_rays)
    pixels = tj.images[frame].reshape(HW * HW, -1)[inds].astype(
        jnp.float32) / 255.0
    bg = jax.random.uniform(k_bg, (tcfg.num_rays, 3))
    gt = pixels[:, :3] * pixels[:, 3:] + bg * (1 - pixels[:, 3:])
    tab = tj._anchor_table()
    rays = jax_get_rays(tj.poses[frame], tj.intrinsics, HW, HW, inds)

    def anchor(o, d, xs, sv):
        return jax_frames_from_table(tab, xs, sv, cj.bound)

    def field(x, d, f):
        return jcf.forward(params, tj.field_state, x, d, cj, tj.runtime,
                           key=k_noise, training=True, frames=f)

    out = jr.render_rays(field, jstate.occ.occ, rays["rays_o"],
                         rays["rays_d"], rj, max_samples=rj.max_samples_train,
                         key=k_perturb, perturb=True, bg_color=bg,
                         anchor_fn=anchor)
    loss = jnp.mean(jnp.mean((out["image"] - gt) ** 2, axis=-1))
    n_est, n_grad = out["normal"], jax.lax.stop_gradient(out["normal_grad"])
    finite = (jnp.all(jnp.isfinite(n_grad), axis=-1)
              & (jnp.sum(n_grad * n_grad, -1) > 1e-8))
    n_est_n = n_est * jax.lax.rsqrt(jnp.sum(n_est * n_est, -1,
                                            keepdims=True) + 1e-10)
    n_grad_n = n_grad * jax.lax.rsqrt(jnp.sum(n_grad * n_grad, -1,
                                              keepdims=True) + 1e-10)
    err = -jnp.minimum(jnp.sum(n_grad_n * n_est_n, -1),
                       tcfg.normal_cosine_threshold)
    loss = loss + jnp.sum(jnp.where(finite, err, 0.0)) \
        / jnp.maximum(jnp.sum(finite), 1)
    return loss + jcf.regular_loss(params, cj, jstate.step, key=k_reg)


def _port_state(setup, jstate):
    """The port's state holding a JAX state's params, EMA and grid."""
    st = tct.init_curved_state(
        torch.Generator(), setup["ct"], setup["rt"], setup["tt_cfg"],
        params=params_from_jax(jax.tree.map(np.asarray, jstate.params),
                               device="cpu"))
    st.ema_params = params_from_jax(jax.tree.map(np.asarray,
                                                 jstate.ema_params),
                                    device="cpu")
    o = jstate.occ
    st.occ = occupancy_from_jax(o.density, o.occ, o.mean_density,
                                o.iter_density, device="cpu")
    return st


def _step_kw(setup):
    tj = setup["tj"]
    return dict(ccfg=setup["ct"], rcfg=setup["rt"], tcfg=setup["tt_cfg"],
                H=HW, W=HW, rt=tmf.FieldRuntime.default(),
                anchor_tab=setup["tab_t"])


def _data(setup):
    ds = setup["ds"]
    return _t(ds.poses), _t(ds.images), _t(ds.intrinsics)


def test_one_train_step_matches_jax(setup):
    tj, cj, rj, tcfg = setup["tj"], setup["cj"], setup["rj"], \
        setup["tj_cfg"]
    jstate = tj.state
    key, frame = jax.random.PRNGKey(21), 2
    _, metrics = jct.curved_train_step(
        jstate, tj.field_state, tj.poses, tj.images, tj.intrinsics,
        jnp.asarray(frame), key, ccfg=cj, rcfg=rj, tcfg=tcfg, H=HW, W=HW,
        rt=tj.runtime, anchor_tab=setup["tab_j"])
    lj, g_j = jax.jit(jax.value_and_grad(lambda p, st, k: _jax_loss(
        p, st, tj, frame, k, cj, rj, tcfg)))(jstate.params, jstate, key)
    # the rebuilt loss is JAX's step loss (two XLA programs: fused sums
    # may round differently in the last bits)
    _rel(lj, metrics["loss"], 1e-5)
    pstate = _port_state(setup, jstate)
    batch = _batch(key, frame, tcfg)
    poses, images, intr = _data(setup)
    lt, out = tct.curved_train_loss(pstate.params, pstate.occ, batch,
                                    setup["st"], poses, images, intr,
                                    **_step_kw(setup))
    assert {"normal", "normal_grad"} <= set(out)
    lt.backward(inputs=tct.param_leaves(pstate.params))
    _rel(lt, lj, 1e-3)
    got = _flat({k: v for k, v in _grad_tree(pstate.params).items()})
    want = _flat(jax.tree.map(np.asarray, g_j))
    assert got.keys() == want.keys()
    moved = 0
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=5e-2 * float(np.abs(w).max()),
                                   err_msg=str(path))
        moved += float(np.abs(w).max()) > 0
    # every leaf has a gradient but the cluster centres': at init the
    # soft assignment is uniform, equal to its target, and the KL's
    # gradient cancels exactly (in JAX too)
    assert moved == len(want) - 1
    assert float(np.abs(want[("field", "clusters")]).max()) == 0.0
    # the whole step runs and counts, on the same draws
    pstate.optimizer.zero_grad(set_to_none=True)
    m = tct.curved_train_step(pstate, batch, setup["st"], poses, images,
                              intr, **_step_kw(setup))
    assert pstate.step == 1
    _rel(m["loss"], lj, 1e-3)


def _grad_tree(params):
    return jax.tree.map(lambda t: t.grad, params,
                        is_leaf=lambda t: torch.is_tensor(t))


def _grid_noise(key, n):
    """The jitter JAX's sparse refresh draws from ``key`` (one chunk)."""
    half = 1.0 / RENDER["grid_size"]
    _, k = jax.random.split(key)
    return np.array(jax.random.uniform(k, (262144, 3), minval=-half,
                                       maxval=half))[:n]


def _heldout(tj, tt, parity):
    pose = orbit_pose(np.pi / 2 + 0.2, 0.3, 2.0)
    gt = tsyn.render_gt_sphere(pose, tt.dataset.intrinsics, HW, HW, 0.5)
    gt = gt.astype(np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    got = tt.render_frame(pose, use_ema=False, parity=parity)
    want = tj.render_frame(pose, use_ema=False, parity=parity)
    return psnr(got["image"], gt), psnr(np.asarray(want["image"]), gt)


def test_training_in_lockstep_with_jax(setup):
    tj0, cj, rj, tcfg = setup["tj"], setup["cj"], setup["rj"], \
        setup["tj_cfg"]
    ct, rt = setup["ct"], setup["rt"]
    jstate = tj0.state
    pstate = _port_state(setup, jstate)
    near = tj0._get_near_cells()
    assert len(near) < 262144
    poses, images, intr = _data(setup)
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(33)
    losses_j, losses_t = [], []
    for step in range(24):
        if step % TRAIN["grid_update_interval"] == 0:     # 3 refreshes
            key, k = jax.random.split(key)
            jstate = jct.curved_grid_step(
                jstate, tj0.field_state, k, ccfg=cj, rcfg=rj,
                near_cells=near, anchor_tab=setup["tab_j"],
                rt=tj0.runtime)
            view = dataclasses.replace(
                pstate, params=tct.curved_infer_params(pstate.params, ct))
            tct.curved_grid_step(view, setup["st"],
                                 [torch.from_numpy(_grid_noise(k, len(near)))],
                                 ccfg=ct, rcfg=rt, near_cells=near,
                                 anchor_tab=setup["tab_t"],
                                 rt=tmf.FieldRuntime.default())
            pstate.occ = view.occ
        frame = int(rng.integers(0, 4))
        key, k = jax.random.split(key)
        jstate, mj = jct.curved_train_step(
            jstate, tj0.field_state, tj0.poses, tj0.images, tj0.intrinsics,
            jnp.asarray(frame), k, ccfg=cj, rcfg=rj, tcfg=tcfg, H=HW, W=HW,
            rt=tj0.runtime, anchor_tab=setup["tab_j"])
        mt = tct.curved_train_step(pstate, _batch(k, frame, tcfg),
                                   setup["st"], poses, images, intr,
                                   **_step_kw(setup))
        losses_j.append(float(mj["loss"]))
        losses_t.append(float(mt["loss"]))
    losses_j, losses_t = np.asarray(losses_j), np.asarray(losses_t)
    assert pstate.step == 24 and int(jstate.step) == 24
    diff = np.abs(losses_t - losses_j)
    assert diff[:TRAIN["grid_update_interval"]].max() <= 1e-2, diff
    assert diff.max() <= 0.1, diff
    assert abs(losses_t.mean() - losses_j.mean()) <= 1e-2
    # held-out frames of both trainers on the lockstep states
    tj = jct.CurvedTrainer(setup["ds"], tj0.field_state, cj, rj, tcfg,
                           key=jax.random.PRNGKey(0))
    tj.state = jstate
    tt = tct.CurvedTrainer(
        tsyn.SyntheticSphereDataset(n_frames=4, H=HW, W=HW), setup["st"], ct,
        rt, setup["tt_cfg"], device="cpu")
    tt.state = pstate
    tt._anchor_tab = (setup["st"].projector, True, setup["tab_t"])
    for parity in (False, True):
        p_t, p_j = _heldout(tj, tt, parity)
        assert abs(p_t - p_j) <= 0.3, (parity, p_t, p_j)
        assert p_j > 10.0


def test_inference_tables_follow_the_params(setup):
    """A step updates the params in place; the next refresh and render
    must read tables made from the new params, not the cached copy."""
    ct, rt = setup["ct"], setup["rt"]
    tt = tct.CurvedTrainer(
        tsyn.SyntheticSphereDataset(n_frames=4, H=HW, W=HW), setup["st"], ct,
        rt, setup["tt_cfg"], device="cpu", seed=3)
    tt.initialize_states(1)
    before = tt._infer_params(tt.state.params)["field"]["encoder"].clone()
    tt.train(1)
    assert tt.state.step == 1
    enc = tt.state.params["field"]["encoder"]
    now = tt._infer_params(tt.state.params)["field"]["encoder"]
    want = tct.inference_table(enc.detach(), ct.field.feature_spec)
    assert not torch.equal(want, before)          # the step moved the table
    assert torch.equal(now, want)
    # the refresh reads the new table: its grid equals one computed from
    # freshly made inference params with the same draws
    g = torch.Generator().set_state(tt.generator.get_state())
    occ0 = tt.state.occ
    tt._refresh()
    near = tt._get_near_cells()
    draws = tocc.sparse_draws(g, near.shape[0], grid_size=rt.grid_size,
                              cascades=1, bound=rt.bound)
    view = dataclasses.replace(
        tt.state, occ=occ0,
        params=tct.curved_infer_params(tt.state.params, ct))
    tct.curved_grid_step(view, tt.field_state, draws, ccfg=ct, rcfg=rt,
                         near_cells=near, anchor_tab=tt._anchor_table(),
                         rt=tt.runtime)
    assert torch.equal(tt.state.occ.density, view.occ.density)
    # the EMA has its own entry, made at the same version
    ema = tt._infer_params(tt.state.ema_params)
    assert tt._infer_params(tt.state.params)["field"]["encoder"] is now
    assert ema["field"]["encoder"] is not now


def test_train_loop_and_unported_features(setup):
    ct, rt = setup["ct"], setup["rt"]
    tt = tct.CurvedTrainer(
        tsyn.SyntheticSphereDataset(n_frames=4, H=HW, W=HW), setup["st"], ct,
        rt, setup["tt_cfg"], device="cpu", seed=5)
    out = tt.train(9)                  # refreshes before steps 0 and 8
    assert len(out["losses"]) == 9 and np.isfinite(out["losses"]).all()
    assert out["loss"] == out["losses"][-1]
    assert int(tt.state.occ.iter_density) == 2 and tt.state.step == 9
    for change in (dict(distillation=True), dict(optimize_camera=True),
                   dict(optimize_gamma=True), dict(error_map=True),
                   dict(iters_per_level=100)):
        tt.tcfg = dataclasses.replace(setup["tt_cfg"], **change)
        with pytest.raises(NotImplementedError, match="item 11.4"):
            tt.train(1)
    tt.tcfg = setup["tt_cfg"]
    # params replaced without their optimizer would train stale tensors
    tt.state.params = params_from_jax(setup["p"], device="cpu")
    with pytest.raises(ValueError, match="init_curved_state"):
        tt.train(1)
