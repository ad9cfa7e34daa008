"""The curved trainer's feature steps in the PyTorch port vs the JAX
package: the distillation step from an NGP teacher, 16 training steps in
lockstep with camera optimisation on, and ``CurvedTrainer.train`` with
every feature on (distillation coins, error map, camera, gamma,
logging).  The small width, the setup and the tolerances are those of
``tests/test_torch_training_features.py``, whose helpers this file
uses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_training_features import (
    FIELD, HW, L, N_FRAMES, NGP, RENDER, TRAIN, _configs, _data, _flat,
    _make_setup, _moved, _np, _port_state, _rel, _step_kw, _t, _batch)
from nerf_texture_tpu.data.rays import get_rays as jax_get_rays
from nerf_texture_tpu.data.rays import sample_ray_indices as jax_sample
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.ops import march_rays as jax_march
from nerf_texture_tpu.ops import near_far_from_aabb as jax_near_far
from nerf_texture_tpu.render import compact as jcompact
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu_torch.convert import params_from_jax
from nerf_texture_tpu_torch.data import synthetic as tsyn
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.train import curved_trainer as tct

setup = pytest.fixture(scope="module")(_make_setup)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads a worker for this module: beside
    pytest-xdist's other workers a full thread pool makes every small op
    wait on the busy cores (as in tests/test_torch_projection.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# distillation
# ---------------------------------------------------------------------------

def _jax_distill_loss(params, jstate, tj, t_params, frame, key, cj, ncfg, rj,
                      tcfg):
    """The loss of JAX's ``distill_step`` rebuilt from its pieces."""
    k_pix, k_perturb, k_noise = jax.random.split(key, 3)
    inds, _ = jax_sample(k_pix, HW, HW, tcfg.num_rays)
    rays = jax_get_rays(tj.poses[frame], tj.intrinsics, HW, HW, inds)
    aabb = jnp.asarray([-rj.bound] * 3 + [rj.bound] * 3)
    nears, fars = jax_near_far(rays["rays_o"], rays["rays_d"], aabb,
                               rj.min_near)
    m = jax_march(rays["rays_o"], rays["rays_d"], jstate.occ.occ, nears,
                  fars, bound=rj.bound, cascades=rj.cascades,
                  grid_size=rj.grid_size, max_steps=rj.max_steps,
                  max_samples=rj.max_samples_train, dt_gamma=rj.dt_gamma,
                  perturb=True, key=k_perturb)
    flat = jcompact.flatten_samples(m, tcfg.num_rays * 32)
    xyzs, dirs = jcompact.flat_points(rays["rays_o"], rays["rays_d"], flat,
                                      rj.bound)
    sig_t, rgb_t = jngp.forward(t_params, xyzs, dirs, ncfg)
    x_seed = jnp.clip(rays["rays_o"] + m.ts[:, :1] * rays["rays_d"],
                      -rj.bound, rj.bound)
    rframes = jct._ray_frames(tj.field_state, x_seed, m.counts > 0, cj)
    rid = jnp.clip(flat.ray_id, 0, tcfg.num_rays - 1)
    frames = jax.tree.map(lambda a: a[rid], rframes)
    sigma, color, _ = jcf.forward(params, tj.field_state, xyzs, dirs, cj,
                                  key=k_noise, training=True, frames=frames)
    valid = flat.valid
    n = jnp.maximum(jnp.sum(valid), 1)
    return (jnp.sum(jnp.where(valid[:, None], (color - rgb_t) ** 2, 0.0))
            / (3 * n)
            + jnp.sum(jnp.where(valid, ((1 - jnp.exp(-sigma))
                                        - (1 - jnp.exp(-sig_t))) ** 2, 0.0))
            / n)


def test_distill_step_matches_jax(setup):
    tj, cj, rj, tcfg = setup["tj"], setup["cj"], setup["rj"], \
        setup["tj_cfg"]
    ncfg_j = jngp.NGPConfig(**NGP)
    # a teacher whose density is not flat: the init grid scaled up
    t_np = jax.tree.map(np.asarray, jngp.init(jax.random.PRNGKey(9), ncfg_j))
    t_np["grid"] = t_np["grid"] * 1e3
    t_j = jax.tree.map(jnp.asarray, t_np)
    jstate = _moved(tj.state)
    key, frame = jax.random.PRNGKey(5), 1
    _, metrics = jct.distill_step(
        jstate, tj.field_state, t_j, tj.poses, tj.images, tj.intrinsics,
        jnp.asarray(frame), key, ccfg=cj, ncfg=ncfg_j, rcfg=rj, tcfg=tcfg)
    lj, g_j = jax.jit(jax.value_and_grad(lambda p, st, k: _jax_distill_loss(
        p, st, tj, t_j, frame, k, cj, ncfg_j, rj, tcfg)))(
        jstate.params, jstate, key)
    _rel(lj, metrics["loss"], 1e-5)
    assert float(lj) > 1e-3
    pstate = _port_state(setup, jstate)
    k_pix, k_perturb, k_noise = jax.random.split(key, 3)
    n = tcfg.num_rays
    batch = tct.DistillBatch(
        frame=torch.tensor(frame),
        inds=_t(jax_sample(k_pix, HW, HW, n)[0], torch.int64),
        u=_t(jax.random.uniform(k_perturb, (n,), jnp.float32)),
        noise=_t(jax.random.normal(k_noise, (n * tct.DISTILL_SAMPLES,
                                             L * FIELD["level_dim"]))))
    poses, _, intr = _data(setup)
    kw = dict(ccfg=setup["ct"], ncfg=tngp.NGPConfig(**NGP),
              rcfg=setup["rt"], tcfg=setup["tt_cfg"], H=HW, W=HW)
    t_t = params_from_jax(t_np, device="cpu")
    lt = tct.distill_loss(pstate.params, pstate.occ, batch, setup["st"], t_t,
                          poses, intr, **kw)
    lt.backward(inputs=tct.param_leaves(pstate.params))
    _rel(lt, lj, 1e-3)
    got = _flat(jax.tree.map(
        lambda t: t.grad if t.grad is not None else torch.zeros_like(t),
        pstate.params, is_leaf=lambda t: torch.is_tensor(t)))
    want = _flat(jax.tree.map(np.asarray, g_j))
    assert got.keys() == want.keys()
    moved = 0
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=5e-2 * float(np.abs(w).max()),
                                   err_msg=str(path))
        moved += float(np.abs(w).max()) > 0
    assert moved >= 5
    # the camera and the gammas are not in the loss: zero in JAX, absent
    # here until the step fills them with zeros
    for path in (("camera", "dRs"), ("gammas",)):
        assert float(np.abs(want[path]).max()) == 0.0
    pstate.optimizer.zero_grad(set_to_none=True)
    before = pstate.params["gammas"].detach().clone()
    m = tct.distill_step(pstate, batch, setup["st"], t_t, poses, intr, **kw)
    _rel(m["loss"], lj, 1e-3)
    assert pstate.step == int(jstate.step) + 1
    # a zero gradient on a leaf with no moments leaves it where it was
    assert torch.equal(pstate.params["gammas"], before)


# ---------------------------------------------------------------------------
# lockstep with camera optimisation, and the trainer's loop
# ---------------------------------------------------------------------------

def test_training_with_camera_in_lockstep_with_jax(setup):
    """16 steps with camera optimisation on (the reference's reg weight
    schedule, the deltas from zero), at lr 5e-4.  A delta's first steps
    are Adam's +-lr whatever the gradient's size, and where a delta's
    photometric gradient is within bf16 rounding of zero (the one-step
    test holds the gradients at 5e-2 of their leaf) the two packages step
    it opposite ways: at lr 5e-3 such a flip turns the frame's rays by
    0.01 rad and moves the loss by 0.1-0.4 from the third step on.  At
    5e-4 a flip moves the rays a twentieth of a pixel."""
    cj, ct, rj, rt, tj_cfg, tt_cfg = _configs(optimize_gamma=False,
                                              error_map=False, lr=5e-4)
    tj0 = jct.CurvedTrainer(setup["ds"], setup["tj"].field_state, cj, rj,
                            tj_cfg, key=jax.random.PRNGKey(0))
    tj0.state = tj0.state._replace(occ=setup["tj"].state.occ)
    jstate = tj0.state
    assert "camera" in jstate.params and "gammas" not in jstate.params
    s = dict(setup, ct=ct, rt=rt, tt_cfg=tt_cfg)
    pstate = _port_state(s, jstate)
    near = setup["tj"]._get_near_cells()
    poses, images, intr = _data(setup)
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(33)
    losses_j, losses_t = [], []
    for step in range(16):
        if step % TRAIN["grid_update_interval"] == 0:
            key, k = jax.random.split(key)
            jstate = jct.curved_grid_step(
                jstate, tj0.field_state, k, ccfg=cj, rcfg=rj,
                near_cells=near, anchor_tab=setup["tab_j"], rt=tj0.runtime)
            view = dataclasses.replace(
                pstate, params=tct.curved_infer_params(pstate.params, ct))
            half = 1.0 / RENDER["grid_size"]
            noise = np.array(jax.random.uniform(
                jax.random.split(k)[1], (262144, 3), minval=-half,
                maxval=half))[:len(near)]
            tct.curved_grid_step(view, setup["st"],
                                 [torch.from_numpy(noise)], ccfg=ct, rcfg=rt,
                                 near_cells=near, anchor_tab=setup["tab_t"],
                                 rt=tmf.FieldRuntime.default())
            pstate.occ = view.occ
        frame = int(rng.integers(0, N_FRAMES))
        key, k = jax.random.split(key)
        jstate, mj = jct.curved_train_step(
            jstate, tj0.field_state, tj0.poses, tj0.images, tj0.intrinsics,
            jnp.asarray(frame), k, ccfg=cj, rcfg=rj, tcfg=tj_cfg, H=HW, W=HW,
            rt=tj0.runtime, anchor_tab=setup["tab_j"])
        mt = tct.curved_train_step(pstate, _batch(k, frame, tt_cfg),
                                   setup["st"], poses, images, intr,
                                   **_step_kw(s))
        losses_j.append(float(mj["loss"]))
        losses_t.append(float(mt["loss"]))
    losses_j, losses_t = np.asarray(losses_j), np.asarray(losses_t)
    assert pstate.step == 16 and int(jstate.step) == 16
    diff = np.abs(losses_t - losses_j)
    assert diff[:TRAIN["grid_update_interval"]].max() <= 1e-2, diff
    assert diff.max() <= 0.1, diff
    assert abs(losses_t.mean() - losses_j.mean()) <= 1e-2
    # the camera deltas moved, and moved alike
    for k in ("dRs", "dts", "dfs"):
        dj = np.asarray(jstate.params["camera"][k])
        dt = _np(pstate.params["camera"][k])
        assert np.abs(dj).max() > 1e-4, k
        np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-4, err_msg=k)


def test_trainer_loop_runs_every_feature(setup, tmp_path):
    ct, rt = setup["ct"], setup["rt"]
    ds = tsyn.SyntheticSphereDataset(n_frames=N_FRAMES, H=HW, W=HW)
    ncfg = tngp.NGPConfig(**NGP)
    teacher = (tngp.init(torch.Generator().manual_seed(1), ncfg), ncfg)
    tcfg = dataclasses.replace(setup["tt_cfg"], distillation=True,
                               distillation_prob=0.5)
    tt = tct.CurvedTrainer(ds, setup["st"], ct, rt, tcfg, device="cpu",
                           seed=5, teacher=teacher,
                           workspace=str(tmp_path))
    assert tt.state.error_map.shape == (N_FRAMES, 128 * 128)
    assert tuple(tt.state.params["camera"]["dfs"].shape) == (N_FRAMES, 2)
    np.testing.assert_array_equal(_np(tt.state.params["gammas"]),
                                  np.float32(2.4))
    out = tt.train(10, log_every=5)
    assert len(out["losses"]) == 10 and np.isfinite(out["losses"]).all()
    assert tt.state.step == 10
    assert (tt.state.error_map != 1).any()
    assert torch.isfinite(tt.state.params["camera"]["dRs"]).all()
    assert (tmp_path / "log_curved.jsonl").read_text().count("\n") == 2
    # without a teacher distillation is skipped, as in the JAX trainer
    tt.teacher = None
    tt.train(2)
    assert tt.state.step == 12
    # progressive levels run beside every feature (the hash encoder has
    # no level to advance, as in JAX)
    tt.tcfg = dataclasses.replace(tcfg, iters_per_level=4)
    assert np.isfinite(tt.train(1)["loss"])
    assert tt.state.step == 13 and tt.fea_level == 0
