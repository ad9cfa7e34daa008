"""The curved model's training features in the PyTorch port vs the JAX
package: the Rodrigues rotation, the camera deltas and their
regulariser, the camera term's weight schedule, error-map pixel
sampling, and one training step with camera, gamma and error map all on
(the distillation step, a lockstep run with camera optimisation on and
the trainer's loop are in tests/test_torch_training_steps.py).

Small width: the configs of ``tests/test_torch_curved_train.py`` with the
SH light (so the gamma reaches the colour), ``make_icosphere(2, 0.5)``,
32x32 frames.  The port takes its draws as arguments; every comparison
hands it the draws JAX made, recomputed here from the keys the JAX
functions split.

Tolerances, each with its reason:
- rotations: 1e-6, their gradients 1e-6 (at 0 and at unit-scale
  vectors; near 0 the axis v / theta passes a last-bit difference of
  theta on at 1 / theta, so vectors of norm ~1e-3 are held at
  1e-6 / theta); the camera deltas and their regulariser 1e-6,
  gradients 1e-5 (the same f32 formulas; XLA and torch round sin, cos
  and sqrt in their own last bits);
- the camera term of ``regular_loss``: 1e-6 relative;
- error-map sampling: indices exact where no two perturbed logits lie
  within rounding of each other.  XLA's and torch's f32 ``log`` differ
  in the last bit on ~20% of inputs, so two cells whose logit + Gumbel
  keys lie within a few ulps may change places; at 256 rays (the gaps at
  the top of 16,384 keys are ~1e-4) every index agrees, and at 4096
  rays every disagreement is such a near tie;
- one step, and the distillation step: the loss within 1e-3 relative,
  each parameter leaf's gradient within 5e-2 of the leaf's largest entry
  (PR 2's bound: bf16 cotangents of the table rows); the error map after
  the step: unchanged outside the sampled cells, 0.1 old + 0.9 the
  port's per-ray MSE at them (1e-6 relative), and within 1e-4 of JAX's
  map there (a ray's MSE moves by about 2 |error| x its colour
  difference, which bf16 table rows put at ~1e-4: 3.2e-5 measured);
- lockstep: PR 5's bounds (tests/test_torch_curved_train.py) -- the loss
  within 1e-2 at every step of the first refresh cycle, within 0.1 at
  every step, its mean within 1e-2.
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
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu.utils import transforms as jtf
from nerf_texture_tpu_torch.convert import occupancy_from_jax, params_from_jax
from nerf_texture_tpu_torch.data import rays as trays
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
from nerf_texture_tpu_torch.geometry.projector import MeshProjector
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train import curved_trainer as tct
from nerf_texture_tpu_torch.utils import transforms as ttf

FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=True)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
RENDER = dict(bound=1.0, cascades=1, grid_size=16, max_steps=48,
              max_samples_train=24, max_samples_infer=32, ray_chunk=256,
              pool_mean_samples=16, pool_mean_samples_infer=16,
              proxy_samples=0)
TRAIN = dict(lr=5e-3, total_steps=200, num_rays=64, grid_update_interval=8,
             grid_full_updates=4, optimize_camera=True, optimize_gamma=True,
             error_map=True)
NGP = dict(bound=1.0, num_levels=4, level_dim=2, log2_bricks=10,
           desired_resolution=64, hidden_dim=32, hidden_dim_color=32)
HW = 32
L = FIELD["num_levels"]
N_FRAMES = 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads a worker for this module: beside
    pytest-xdist's other workers a full thread pool makes every small op
    wait on the busy cores (as in tests/test_torch_projection.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rel(a, b, rtol):
    a = a.detach() if torch.is_tensor(a) else a
    np.testing.assert_allclose(float(a), float(b), rtol=rtol, atol=0)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat(tree[k],
                                                     prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree)
                for p, v in _flat(x, prefix + (i,)).items()}
    return {prefix: _np(tree)}


def _grad_tree(params):
    return jax.tree.map(lambda t: t.grad, params,
                        is_leaf=lambda t: torch.is_tensor(t))


# ---------------------------------------------------------------------------
# rotations and the camera deltas
# ---------------------------------------------------------------------------

def _rotvecs():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(40, 3)).astype(np.float32)
    v[:10] *= 1e-3
    v[10] = 0.0
    return v


def test_axis_angle_matches_jax():
    v = _rotvecs()
    w = np.random.default_rng(1).normal(size=(40, 3, 3)).astype(np.float32)
    rj, gj = jax.value_and_grad(
        lambda x: jnp.sum(jtf.axis_angle_to_matrix(x) * w))(jnp.asarray(v))
    vt = _t(v).requires_grad_(True)
    rt = ttf.axis_angle_to_matrix(vt)
    np.testing.assert_allclose(_np(rt), np.asarray(
        jtf.axis_angle_to_matrix(jnp.asarray(v))), rtol=0, atol=1e-6)
    torch.sum(rt * _t(w)).backward()
    g = _np(vt.grad)
    assert np.isfinite(g).all()             # finite at exactly 0
    # the axis v / theta passes a rounding of theta on at 1 / theta: the
    # 1e-3 vectors are held at 1e-6 / theta
    theta = np.linalg.norm(v, axis=-1, keepdims=True)
    err = np.abs(g - np.asarray(gj))
    with np.errstate(divide="ignore"):
        bound = 1e-6 * np.maximum(1.0, 1.0 / theta)
    assert np.all(err <= bound), (err.max(-1), bound[:, 0])
    # at 0 the rotation is the identity and the gradient that of K
    np.testing.assert_array_equal(_np(rt[10]), np.eye(3, dtype=np.float32))
    np.testing.assert_allclose(
        _np(ttf.euler_to_matrix([0.1, -0.2, 0.3])),
        np.asarray(jtf.euler_to_matrix([0.1, -0.2, 0.3])), rtol=0, atol=1e-6)


def _cam(seed):
    rng = np.random.default_rng(seed)
    cam = {"dRs": rng.normal(size=(N_FRAMES, 3)) * 0.05,
           "dts": rng.normal(size=(N_FRAMES, 3)) * 0.05,
           "dfs": rng.normal(size=(N_FRAMES, 2)) * 2.0}
    cam = {k: v.astype(np.float32) for k, v in cam.items()}
    if seed == 0:                           # where training starts
        cam = {k: np.zeros_like(v) for k, v in cam.items()}
    cam["dRs"][1] = 0.0                     # one frame at zero
    return cam


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_deltas_match_jax(seed):
    cam = _cam(seed)
    ds = SyntheticSphereDataset(n_frames=N_FRAMES, H=HW, W=HW)
    pose, intr = ds.poses[2], ds.intrinsics
    wp = np.random.default_rng(5).normal(size=(4, 4)).astype(np.float32)
    wk = np.array([1.0, -2.0, 3.0, 4.0], np.float32)

    def jloss(c):
        p, k = jct._apply_camera_deltas(jnp.asarray(pose), jnp.asarray(intr),
                                        c, 2)
        return (jct.camera_regularization(c) + jnp.sum(p * wp)
                + jnp.sum(k * wk)), (p, k)

    (lj, (pj, kj)), gj = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, cam))
    ct = {k: _t(v).requires_grad_(True) for k, v in cam.items()}
    pt, kt = tct.apply_camera_deltas(_t(pose), _t(intr), ct,
                                     torch.tensor(2))
    reg = tct.camera_regularization(ct)
    np.testing.assert_allclose(_np(reg), np.asarray(
        jct.camera_regularization(jax.tree.map(jnp.asarray, cam))),
        rtol=1e-6, atol=0)
    np.testing.assert_allclose(_np(pt), np.asarray(pj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(kt), np.asarray(kj), rtol=0, atol=1e-6)
    # cx, cy untouched; the last pose row exact
    np.testing.assert_array_equal(_np(kt)[2:], intr[2:])
    np.testing.assert_array_equal(_np(pt)[3], [0, 0, 0, 1])
    lt = reg + torch.sum(pt * _t(wp)) + torch.sum(kt * _t(wk))
    _rel(lt, lj, 1e-6)
    lt.backward()
    for k in cam:
        g = _np(ct[k].grad)
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, np.asarray(gj[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_camera_term_of_regular_loss_matches_jax():
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**FIELD), **MODEL)
    ct = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**FIELD), **MODEL)
    p = jax.tree.map(np.asarray, jcf.init(jax.random.PRNGKey(0), cj))
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_jax(p, device="cpu")
    cam = _cam(1)
    cam_j = jct.camera_regularization(jax.tree.map(jnp.asarray, cam))
    cam_t = tct.camera_regularization({k: _t(v) for k, v in cam.items()})
    key = jax.random.PRNGKey(3)
    level = int(jax.random.randint(key, (), 0, L))
    base = float(tcf.regular_loss(pt, ct, 0, level=level))
    for step, weight in ((2000, None), (2001, None), (5, 0.5), (3000, 7.0)):
        want = jcf.regular_loss(pj, cj, jnp.asarray(step, jnp.int32),
                                optimize_camera_loss=cam_j, key=key,
                                camera_reg_weight=weight)
        got = tcf.regular_loss(pt, ct, step, optimize_camera_loss=cam_t,
                               level=level, camera_reg_weight=weight)
        _rel(got, want, 1e-6)
        w = weight if weight is not None else (1e4 if step <= 2000 else 1e2)
        _rel(got - base, w * float(cam_t), 1e-5)


# ---------------------------------------------------------------------------
# error-map sampling
# ---------------------------------------------------------------------------

def _jax_emap_draws(key, n):
    k1, k2, k3 = jax.random.split(key, 3)
    return (jax.random.uniform(k1, (128 * 128,), minval=1e-9, maxval=1.0),
            jax.random.uniform(k2, (n,)), jax.random.uniform(k3, (n,)))


def _error_map(seed):
    rng = np.random.default_rng(seed)
    em = np.ones((128 * 128,), np.float32)
    em[rng.choice(em.size, 4000, replace=False)] = rng.uniform(
        0, 3, 4000).astype(np.float32)
    em[:50] = 0.0                            # clipped to 1e-12
    return em


@pytest.mark.parametrize("H,W", [(32, 32), (45, 70), (400, 400)])
@pytest.mark.parametrize("seed", [0, 1])
def test_error_map_sampling_matches_jax(H, W, seed):
    em = _error_map(seed)
    key = jax.random.PRNGKey(seed)
    n = 256
    want_i, want_c = jax_sample(key, H, W, n, error_map=jnp.asarray(em))
    draws = tuple(_t(d) for d in _jax_emap_draws(key, n))
    got_i, got_c = trays.sample_ray_indices(None, H, W, n,
                                            error_map=_t(em), draws=draws)
    np.testing.assert_array_equal(_np(got_c), np.asarray(want_c))
    np.testing.assert_array_equal(_np(got_i), np.asarray(want_i))
    assert got_i.dtype == got_c.dtype == torch.int64
    assert int(got_i.min()) >= 0 and int(got_i.max()) < H * W


def test_error_map_ties_and_near_ties():
    # exact ties (equal uniforms on equal errors) go to the lower cell
    u = np.full((128 * 128,), 0.5, np.float32)
    u[100:] = 0.25
    em = np.ones((128 * 128,), np.float32)
    draws = (_t(u), _t(np.zeros(64, np.float32)),
             _t(np.zeros(64, np.float32)))
    _, cells = trays.sample_ray_indices(None, 128, 128, 64, error_map=_t(em),
                                        draws=draws)
    np.testing.assert_array_equal(_np(cells), np.arange(64))
    want = jax.lax.top_k(jnp.log(jnp.asarray(em))
                         - jnp.log(-jnp.log(jnp.asarray(u))), 64)[1]
    np.testing.assert_array_equal(np.asarray(want), np.arange(64))
    # 4096 rays: every disagreement is a near tie of JAX's own keys
    em = _error_map(3)
    key = jax.random.PRNGKey(7)
    n = 4096
    _, want_c = jax_sample(key, 64, 64, n, error_map=jnp.asarray(em))
    d = _jax_emap_draws(key, n)
    _, got_c = trays.sample_ray_indices(
        None, 64, 64, n, error_map=_t(em), draws=tuple(_t(x) for x in d))
    keys = np.asarray(jnp.log(jnp.clip(jnp.asarray(em), 1e-12, None))
                      - jnp.log(-jnp.log(d[0])))
    want_c, got_c = np.asarray(want_c), _np(got_c)
    off = np.nonzero(want_c != got_c)[0]
    assert len(off) <= n // 50, len(off)
    kw, kg = keys[want_c[off]], keys[got_c[off]]
    assert np.all(np.abs(kw - kg) <= 4 * np.spacing(np.abs(kw))), (kw, kg)


def test_sample_ray_indices_draws_from_the_generator():
    g = torch.Generator().manual_seed(0)
    em = torch.ones(128 * 128)
    inds, cells = trays.sample_ray_indices(g, 40, 50, 300, error_map=em)
    assert inds.shape == cells.shape == (300,)
    assert len(torch.unique(cells)) == 300          # without replacement
    g2 = torch.Generator().manual_seed(0)
    draws = trays.error_map_draws(g2, 300)
    assert float(draws[0].min()) >= 1e-9
    again, _ = trays.sample_ray_indices(None, 40, 50, 300, error_map=em,
                                        draws=draws)
    assert torch.equal(inds, again)
    with pytest.raises(ValueError, match="error map"):
        trays.sample_ray_indices(g, 40, 50, 8, error_map=torch.ones(16))


# ---------------------------------------------------------------------------
# one step with every feature on
# ---------------------------------------------------------------------------

def _configs(**train):
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**FIELD), **MODEL)
    ct = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**FIELD), **MODEL)
    rj = jr.RenderConfig(**RENDER)
    kw = {**TRAIN, **train}
    return (cj, ct, rj, RenderConfig(**dataclasses.asdict(rj)),
            jct.CurvedTrainConfig(**kw), tct.CurvedTrainConfig(**kw))


@pytest.fixture(scope="module")
def setup():
    return _make_setup()


def _make_setup():
    """A JAX CurvedTrainer with every feature on after one grid refresh,
    its anchor table converted, and the port's field state."""
    cj, ct, rj, rt, tj_cfg, tt_cfg = _configs()
    ds = SyntheticSphereDataset(n_frames=N_FRAMES, H=HW, W=HW)
    tj = jct.CurvedTrainer(ds, jmf.make_state(JaxMeshProjector(
        jax_icosphere(2, radius=0.5))), cj, rj, tj_cfg,
        key=jax.random.PRNGKey(0))
    tj.initialize_states(1)
    tab_j = tj._anchor_table()
    st = tmf.make_state(MeshProjector(make_icosphere(2, radius=0.5),
                                      device="cpu"))
    return dict(cj=cj, ct=ct, rj=rj, rt=rt, tj_cfg=tj_cfg, tt_cfg=tt_cfg,
                ds=ds, tj=tj, tab_j=tab_j, tab_t=torch.from_numpy(
                    np.array(tab_j)), st=st)


def _moved(jstate, seed=4):
    """The JAX state with camera deltas, gammas and an error map away
    from their starting values (so each term has work to do)."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, jstate.params)
    p["camera"] = {k: (rng.normal(size=v.shape) * (2.0 if k == "dfs"
                                                    else 0.02)
                       ).astype(np.float32) for k, v in p["camera"].items()}
    p["gammas"] = (2.4 + rng.normal(size=p["gammas"].shape) * 0.1).astype(
        np.float32)
    em = np.asarray(jstate.error_map).copy()
    em[:, rng.choice(em.shape[1], 3000, replace=False)] = rng.uniform(
        0.0, 2.0, (em.shape[0], 3000))
    return jstate._replace(params=jax.tree.map(jnp.asarray, p),
                           ema_params=jax.tree.map(jnp.asarray, p),
                           error_map=jnp.asarray(em))


def _port_state(setup, jstate):
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
    st.error_map = _t(jstate.error_map)
    st.step = int(jstate.step)
    return st


def _batch(key, frame, tcfg):
    k_pix, k_perturb, k_bg, k_noise, k_reg = jax.random.split(key, 5)
    n = tcfg.num_rays
    rows = tct.noise_rows(RenderConfig(**RENDER), n)
    inds = emap = None
    if tcfg.error_map:
        emap = tuple(_t(d) for d in _jax_emap_draws(k_pix, n))
    else:
        inds = _t(jax_sample(k_pix, HW, HW, n)[0], torch.int64)
    return tct.CurvedBatch(
        frame=torch.tensor(int(frame)), inds=inds,
        u=_t(jax.random.uniform(k_perturb, (n,), jnp.float32)),
        bg=_t(jax.random.uniform(k_bg, (n, 3))),
        noise=_t(jax.random.normal(k_noise, (rows, L * FIELD["level_dim"]))),
        level=int(jax.random.randint(k_reg, (), 0, L)), emap=emap)


def _jax_loss(params, jstate, tj, frame, key, cj, rj, tcfg):
    """The loss of JAX's ``_curved_train_step_body`` rebuilt from its
    pieces (the same keys), camera, gamma and error map included."""
    k_pix, k_perturb, k_bg, k_noise, k_reg = jax.random.split(key, 5)
    emap = jstate.error_map[frame] if tcfg.error_map else None
    inds, _ = jax_sample(k_pix, HW, HW, tcfg.num_rays, error_map=emap)
    pixels = tj.images[frame].reshape(HW * HW, -1)[inds].astype(
        jnp.float32) / 255.0
    bg = jax.random.uniform(k_bg, (tcfg.num_rays, 3))
    gt = pixels[:, :3] * pixels[:, 3:] + bg * (1 - pixels[:, 3:])
    tab = tj._anchor_table()
    pose, K = tj.poses[frame], tj.intrinsics
    if tcfg.optimize_camera:
        pose, K = jct._apply_camera_deltas(pose, K, params["camera"], frame)
    rays = jax_get_rays(pose, K, HW, HW, inds)
    g = params["gammas"][frame] if tcfg.optimize_gamma else None

    def anchor(o, d, xs, sv):
        return jax_frames_from_table(tab, xs, sv, cj.bound)

    def field(x, d, f):
        return jcf.forward(params, tj.field_state, x, d, cj, tj.runtime,
                           key=k_noise, training=True, gamma=g, frames=f)

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
    cam = (jct.camera_regularization(params["camera"])
           if tcfg.optimize_camera else None)
    loss = loss + jcf.regular_loss(params, cj, jstate.step,
                                   optimize_camera_loss=cam, key=k_reg,
                                   camera_reg_weight=tcfg.camera_reg_weight)
    if tcfg.optimize_gamma:
        loss = loss + 5.0 * (params["gammas"][frame] - 2.4) ** 2
    return loss


def _data(setup):
    ds = setup["ds"]
    return _t(ds.poses), _t(ds.images), _t(ds.intrinsics)


def _step_kw(setup, tcfg=None):
    return dict(ccfg=setup["ct"], rcfg=setup["rt"],
                tcfg=tcfg or setup["tt_cfg"], H=HW, W=HW,
                rt=tmf.FieldRuntime.default(), anchor_tab=setup["tab_t"])


def test_one_step_with_every_feature_matches_jax(setup):
    tj, cj, rj, tcfg = setup["tj"], setup["cj"], setup["rj"], \
        setup["tj_cfg"]
    jstate = _moved(tj.state)
    key, frame = jax.random.PRNGKey(21), 2
    new_j, metrics = jct.curved_train_step(
        jstate, tj.field_state, tj.poses, tj.images, tj.intrinsics,
        jnp.asarray(frame), key, ccfg=cj, rcfg=rj, tcfg=tcfg, H=HW, W=HW,
        rt=tj.runtime, anchor_tab=setup["tab_j"])
    lj, g_j = jax.jit(jax.value_and_grad(lambda p, st, k: _jax_loss(
        p, st, tj, frame, k, cj, rj, tcfg)))(jstate.params, jstate, key)
    _rel(lj, metrics["loss"], 1e-5)
    pstate = _port_state(setup, jstate)
    batch = _batch(key, frame, setup["tt_cfg"])
    poses, images, intr = _data(setup)
    lt, out = tct.curved_train_loss(
        pstate.params, pstate.occ, batch, setup["st"], poses, images, intr,
        **_step_kw(setup), error_map=pstate.error_map[frame])
    lt.backward(inputs=tct.param_leaves(pstate.params))
    _rel(lt, lj, 1e-3)
    got = _flat(_grad_tree(pstate.params))
    want = _flat(jax.tree.map(np.asarray, g_j))
    assert got.keys() == want.keys()
    assert {("camera", "dRs"), ("camera", "dfs"), ("gammas",)} <= set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=5e-2 * float(np.abs(w).max()),
                                   err_msg=str(path))
    for path in (("camera", "dRs"), ("camera", "dts"), ("camera", "dfs"),
                 ("gammas",)):
        assert float(np.abs(want[path]).max()) > 0, path
    # the gamma prior's and the photometric gradient reach gammas[frame]
    # only; the regulariser reaches every frame's deltas
    assert np.count_nonzero(want[("gammas",)]) == 1
    assert np.all(np.abs(want[("camera", "dRs")]).sum(-1) > 0)
    # the whole step, then the error map
    pstate.optimizer.zero_grad(set_to_none=True)
    m = tct.curved_train_step(pstate, batch, setup["st"], poses, images,
                              intr, **_step_kw(setup))
    _rel(m["loss"], lj, 1e-3)
    em0, em_j, em_t = (np.asarray(jstate.error_map),
                       np.asarray(new_j.error_map), _np(pstate.error_map))
    changed = em_j != em0
    assert changed[frame].sum() > 0 and not changed[np.arange(N_FRAMES)
                                                    != frame].any()
    np.testing.assert_array_equal(em_t[~changed], em0[~changed])
    # the update itself, exactly: 0.1 old + 0.9 the port's per-ray MSE
    cells_t = _np(out["inds_coarse"])
    want_t = 0.1 * em0[frame, cells_t] + 0.9 * _np(out["rgb_loss_per_ray"])
    np.testing.assert_allclose(em_t[frame, cells_t], want_t, rtol=1e-6,
                               atol=0)
    # against JAX's map: a ray's MSE moves by ~2 |err| x its colour
    # difference (bf16 table rows, as above), up to 3.2e-5 here
    np.testing.assert_allclose(em_t[changed], em_j[changed], rtol=0,
                               atol=1e-4)
    _, cells = jax_sample(jax.random.split(key, 5)[0], HW, HW,
                          tcfg.num_rays, error_map=jstate.error_map[frame])
    assert set(np.nonzero(changed[frame])[0]) <= set(np.asarray(cells))
