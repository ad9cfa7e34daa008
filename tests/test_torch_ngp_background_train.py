"""Training the NGP's learned background sphere (``bg_radius > 0``) on the
per-corner encoder in the PyTorch port vs the JAX package: one training
step's loss and gradients (the background net's included) on JAX's
draws, a short run that moves the background net, and checkpoints with
and without the background through ``tolerant_load`` in both directions.

Tolerances, each with its reason:
- the step's loss within 1e-3 relative, its gradients within 5e-2 of each
  leaf's largest entry (``tests/test_torch_train.py``'s bounds: the MLPs
  round operands, activations and their cotangents to bf16 on both
  sides, from f32 values that may differ in the last bit);
- ``tolerant_load``: the missing and unexpected key paths equal to JAX's,
  the values loaded or kept exactly.
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
from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.ops import occupancy as jocc
from nerf_texture_tpu.ops import polar_from_ray as jax_polar
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train import trainer as jt
from nerf_texture_tpu_torch.convert import occupancy_from_jax, params_from_jax
from nerf_texture_tpu_torch.data import synthetic as tsyn
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.render import renderer as tr
from nerf_texture_tpu_torch.train import trainer as tt

H = W = 32
GRID = 16
NGP_KW = dict(bound=1.0, num_levels=4, level_dim=2, log2_hashmap_size=12,
              desired_resolution=256, hidden_dim=32, hidden_dim_color=32,
              encoder="hash", bg_radius=4.0)
RENDER_KW = dict(bound=1.0, cascades=1, grid_size=GRID, max_steps=64,
                 max_samples_train=32, ray_chunk=1024, pool_mean_samples=16,
                 proxy_samples=0, proxy_refined=24, infer_color_cap=4,
                 prepass_block=4, prepass_tau_cull=0.1)
TRAIN_KW = dict(lr=1e-2, total_steps=200, num_rays=256, grid_decay=0.85,
                grid_update_interval=4)
CFG_J = dict(mcfg=jngp.NGPConfig(**NGP_KW), rcfg=jr.RenderConfig(**RENDER_KW),
             tcfg=jt.TrainConfig(**TRAIN_KW))
CFG_T = dict(mcfg=tngp.NGPConfig(**NGP_KW), rcfg=tr.RenderConfig(**RENDER_KW),
             tcfg=tt.TrainConfig(**TRAIN_KW))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads a worker for this module (beside
    pytest-xdist's other workers a full pool makes small ops wait)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def test_one_train_step_with_background_matches():
    ds = SyntheticSphereDataset(n_frames=8, H=H, W=W)
    jstate = jt._init_train_state(jax.random.PRNGKey(2), **CFG_J)
    jstate = jstate._replace(occ=jocc.mark_untrained(
        jstate.occ, jnp.asarray(ds.poses), jnp.asarray(ds.intrinsics),
        grid_size=GRID, cascades=1, bound=1.0))
    # tables scaled so that sigma, colour and the background vary
    params = {**jstate.params, "grid": jstate.params["grid"] * 3e4,
              "bg_grid": jstate.params["bg_grid"] * 3e3}
    jstate = jstate._replace(params=params, ema_params=params)
    kg, ks = jax.random.split(jax.random.PRNGKey(5))
    jstate = jt.grid_step(jstate, kg, mcfg=CFG_J["mcfg"], rcfg=CFG_J["rcfg"],
                          full=True, decay=0.85)
    frame = 3
    _, metrics = jt.train_step(jstate, jnp.asarray(ds.poses),
                               jnp.asarray(ds.images),
                               jnp.asarray(ds.intrinsics), jnp.asarray(frame),
                               ks, H=H, W=W, **CFG_J)
    # JAX's draws, and its loss rebuilt from them for the gradients
    k_pix, k_perturb, k_bg = jax.random.split(ks, 3)
    n = TRAIN_KW["num_rays"]
    inds, _ = jax_sample(k_pix, H, W, n)
    batch = tt.Batch(frame=torch.tensor(frame), inds=_t(inds, torch.int64),
                     u=_t(jax.random.uniform(k_perturb, (n,), jnp.float32)),
                     bg=_t(jax.random.uniform(k_bg, (3,))))
    rays = jax_get_rays(jnp.asarray(ds.poses[frame]),
                        jnp.asarray(ds.intrinsics), H, W, inds)
    pix = (jnp.asarray(ds.images[frame]).reshape(H * W, -1)[inds]
           .astype(jnp.float32) / 255.0)
    bg = jnp.asarray(_np(batch.bg))
    gt = pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])
    mj = CFG_J["mcfg"]

    def loss_j(p):
        polar = jax_polar(rays["rays_o"], rays["rays_d"], mj.bg_radius)
        bg_c = jngp.background(p, polar, rays["rays_d"], mj)
        out = jr.render_rays(lambda x, d: jngp.forward(p, x, d, mj),
                             jstate.occ.occ, rays["rays_o"], rays["rays_d"],
                             CFG_J["rcfg"], max_samples=32, key=k_perturb,
                             perturb=True, bg_color=bg_c)
        return jnp.mean((out["image"] - gt) ** 2)

    lj, g_j = jax.value_and_grad(loss_j)(jstate.params)
    # the rebuilt loss is JAX's step loss (XLA fuses the two programs
    # differently: 1.5e-6 apart measured)
    np.testing.assert_allclose(float(lj), float(metrics["loss"]), rtol=1e-5)
    pstate = tt.init_train_state(
        torch.Generator(), CFG_T["mcfg"], CFG_T["rcfg"], CFG_T["tcfg"],
        params=params_from_jax(jax.tree.map(np.asarray, jstate.params),
                               device="cpu"))
    o = jstate.occ
    pstate.occ = occupancy_from_jax(o.density, o.occ, o.mean_density,
                                    o.iter_density, device="cpu")
    lt, out = tt.train_loss(pstate.params, pstate.occ, batch,
                            _t(ds.poses), _t(ds.images), _t(ds.intrinsics),
                            mcfg=CFG_T["mcfg"], rcfg=CFG_T["rcfg"], H=H, W=W)
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-3)
    # part of every ray's colour is the sphere's: its net has a gradient
    assert float(out["weights_sum"].min()) < 0.5
    got = [p.grad for p in tt.param_leaves(pstate.params)]
    want = jax.tree.leaves(g_j)
    assert set(pstate.params) == set(g_j) >= {"bg_grid", "bg_net"}
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(w).max()) > 0
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=5e-2 * float(np.abs(w).max()))


def test_training_moves_the_background_net():
    ds = tsyn.SyntheticSphereDataset(n_frames=4, H=24, W=24)
    tr_ = tt.Trainer(ds, CFG_T["mcfg"], CFG_T["rcfg"],
                     dataclasses.replace(CFG_T["tcfg"], total_steps=12),
                     seed=0, device="cpu")
    bg0 = tr_.state.params["bg_net"][0]["w"].detach().clone()
    grid0 = tr_.state.params["bg_grid"].detach().clone()
    m = tr_.train(12)
    assert np.isfinite(m["losses"]).all()
    assert not torch.equal(tr_.state.params["bg_net"][0]["w"], bg0)
    assert not torch.equal(tr_.state.params["bg_grid"], grid0)
    out = tr_.render_frame(ds.poses[0], use_ema=False)
    assert out["image"].shape == (24, 24, 3)
    assert bool(torch.isfinite(out["image"]).all())


def _paths_only(keys):
    return sorted(k.split(" (")[0] for k in keys)


def test_tolerant_load_with_and_without_background(tmp_path):
    """A checkpoint without the background into a trainer with one keeps
    the background at its values and reports it missing; the reverse
    reports it unexpected -- the key paths JAX's ``tolerant_load``
    writes."""
    mj_no = dataclasses.replace(CFG_J["mcfg"], bg_radius=-1.0)
    mt_no = dataclasses.replace(CFG_T["mcfg"], bg_radius=-1.0)
    jds = SyntheticSphereDataset(n_frames=4, H=24, W=24)
    tds = tsyn.SyntheticSphereDataset(n_frames=4, H=24, W=24)

    def jax_trainer(mcfg, seed):
        return jt.Trainer(jds, mcfg, CFG_J["rcfg"], CFG_J["tcfg"],
                          key=jax.random.PRNGKey(seed))

    def port_trainer(mcfg, seed):
        return tt.Trainer(tds, mcfg, CFG_T["rcfg"], CFG_T["tcfg"],
                          seed=seed, device="cpu")

    jax_trainer(mj_no, 0).save_checkpoint(str(tmp_path / "j_no"))
    jax_trainer(CFG_J["mcfg"], 0).save_checkpoint(str(tmp_path / "j_bg"))
    src = port_trainer(mt_no, 0)
    src.train(2)
    src.save_checkpoint(str(tmp_path / "t_no"))
    port_trainer(CFG_T["mcfg"], 1).save_checkpoint(str(tmp_path / "t_bg"))

    dst = port_trainer(CFG_T["mcfg"], 1)
    bg_before = dst.state.params["bg_net"][0]["w"].detach().clone()
    jm, ju = jt.tolerant_load(jax_trainer(CFG_J["mcfg"], 1),
                              str(tmp_path / "j_no"))
    tm, tu = tt.tolerant_load(dst, str(tmp_path / "t_no"))
    assert _paths_only(tm) == _paths_only(jm) and tu == ju == []
    assert "params.bg_net" in tm and "params.bg_grid" in tm
    assert torch.equal(dst.state.params["grid"], src.state.params["grid"])
    assert torch.equal(dst.state.params["bg_net"][0]["w"], bg_before)
    assert dst.state.step == 2

    # the reverse: the checkpoint holds keys the model lacks
    jm, ju = jt.tolerant_load(jax_trainer(mj_no, 2), str(tmp_path / "j_bg"))
    tm, tu = tt.tolerant_load(port_trainer(mt_no, 2), str(tmp_path / "t_bg"))
    assert _paths_only(tu) == _paths_only(ju) and tm == jm == []
    assert any("bg_net" in u for u in tu)
    # and a strict load of the same-config checkpoint restores it all
    again = port_trainer(CFG_T["mcfg"], 3)
    again.load_checkpoint(str(tmp_path / "t_bg"))
    for a, b in zip(tt.param_leaves(again.state.params),
                    tt.param_leaves(port_trainer(CFG_T["mcfg"], 1)
                                    .state.params)):
        assert torch.equal(a, b)
