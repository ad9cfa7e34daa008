"""The port's data- and tensor-parallel NGP step (``parallel.
dp_train_step``) over 2 and 4 gloo ranks (processes of
``tests/torch_ranks.py``) vs the JAX package's ``dp_train_step`` on 2 x 1
and 2 x 2 meshes of its virtual CPU devices, and vs the port's own
single-rank step, at ``tests/test_parallel.py``'s configuration, 3 steps.
The draws are JAX's: the march jitter of each step is
``jax.random.uniform(key, (N,))`` of the step's key, which JAX's
``dp_train_step`` draws inside its ``render_rays``.

Tolerances, each with its reason:
- the port against JAX, tests/test_torch_train.py's one-step bounds:
  the loss within 1e-3 relative at each step, the first step's
  gradients within 5e-2 of each leaf's largest entry (bf16 cotangents
  of table rows and activations on both sides; JAX's gradients from
  Adam's first moment after the step);
- the port's data-parallel step against its own single-rank step: the
  loss within 1e-4 relative at each of 3 steps (``tests/test_parallel.py``'s
  bound); the first step's gradients within 2^-8 of each leaf's largest
  entry, and the params after it within 2e-5 wherever the single-rank
  gradient is farther than that bound from zero.  The weight gradient
  passes a bf16 cast (the JAX numerics of ``apply_mlp`` and the table
  read), so each rank rounds its partial sum to bf16 before the sum over
  ranks (measured: 3.2e-3 of the leaf's largest entry), and Adam with
  eps 1e-15 steps every non-zero gradient by +-lr, so an entry whose
  gradient is within that bound of zero may step the other way or not
  at all (measured: 2 of 6.4M table entries at the first step with
  gradients of 1e-9 against a largest entry of 4.8e-4, and an MLP entry
  of -5.0e-11 against 3.0e-6 whose two rounded partial sums cancelled to
  0);
- every rank's params, Adam moments, EMA and grid bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks as R
from nerf_texture_tpu.data.rays import get_rays as jax_get_rays
from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.parallel import sharding as jsh
from nerf_texture_tpu.parallel.train import dp_train_step as jax_dp_step
from nerf_texture_tpu.parallel.train import shard_state as jax_shard_state
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train import trainer as jt
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.parallel import make_mesh, shard_state
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train.trainer import TrainConfig

NGP_KW = dict(bound=1.0, num_levels=4, level_dim=2, base_resolution=16,
              log2_hashmap_size=12, desired_resolution=64, hidden_dim=32,
              hidden_dim_color=32)
RENDER_KW = dict(bound=1.0, cascades=1, grid_size=16, max_steps=32,
                 max_samples_train=16)
TRAIN_KW = dict(lr=1e-2, total_steps=100, num_rays=128)
STEPS = 3


def _jax_np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_jax(tree):
    """{path: numpy} of a JAX tree, paths as the port's (keys, indices)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(getattr(p, "key", getattr(p, "idx", None))
                  for p in path)] = np.asarray(leaf)
    return out


def _leaves_close(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=rel * float(np.abs(w).max()),
                                   err_msg=str(k))



def _ngp_batch():
    ds = SyntheticSphereDataset(n_frames=2, H=16, W=16)
    rays = jax_get_rays(jnp.asarray(ds.poses[0]), jnp.asarray(ds.intrinsics),
                        16, 16)
    gt = jnp.asarray(ds.images[0]).reshape(256, 4).astype(jnp.float32) / 255
    gt_rgb = gt[:, :3] * gt[:, 3:] + (1 - gt[:, 3:])
    n = TRAIN_KW["num_rays"]
    return rays["rays_o"][:n], rays["rays_d"][:n], gt_rgb[:n]


def _jax_ngp(mesh_shape, params):
    """JAX's dp_train_step on a data x model mesh, tests/test_parallel.py's
    run: the losses, and the first step's gradients (from Adam's first
    moment after it, (1 - b1) g)."""
    mcfg, rcfg = jngp.NGPConfig(**NGP_KW), jr.RenderConfig(**RENDER_KW)
    tcfg = jt.TrainConfig(**TRAIN_KW)
    data, model = mesh_shape
    mesh = jsh.make_mesh(data=data, model=model,
                         devices=jax.devices()[:data * model])
    from nerf_texture_tpu.ops import occupancy as jocc
    state = jt.TrainState(params=params,
                          opt_state=jt.make_optimizer(tcfg).init(params),
                          ema_params=params,
                          occ=jocc.create(rcfg.grid_size, rcfg.cascades),
                          step=jnp.zeros((), jnp.int32))
    state = jax_shard_state(state, mesh)
    state = state._replace(occ=state.occ._replace(
        occ=jnp.ones_like(state.occ.occ)))
    spec = jsh.data_sharded(mesh)
    ro, rd, gt = (jax.device_put(a, spec) for a in _ngp_batch())
    losses, grads1 = [], None
    for i in range(STEPS):
        state, loss = jax_dp_step(state, ro, rd, gt, jnp.ones((3,)),
                                  jax.random.PRNGKey(100 + i), mcfg=mcfg,
                                  rcfg=rcfg, tcfg=tcfg, mesh=mesh)
        losses.append(float(loss))
        if i == 0:
            mu = state.opt_state[0].mu
            grads1 = {k: v / (1.0 - tcfg.adam_b1)
                      for k, v in _flat_jax(mu).items()}
    return {"losses": losses, "grads1": grads1}


@pytest.fixture(scope="module")
def ngp_runs(tmp_path_factory):
    """The port's ranks (data 2; data 2 x model 2), started first and run
    while this process computes JAX's runs on 2 x 1 and 2 x 2 meshes and
    the port's single-rank run."""
    params = jngp.init(jax.random.PRNGKey(0), jngp.NGPConfig(**NGP_KW))
    n = TRAIN_KW["num_rays"]
    us = [np.asarray(jax.random.uniform(jax.random.PRNGKey(100 + i), (n,),
                                        jnp.float32)) for i in range(STEPS)]
    ro, rd, gt = (np.asarray(a) for a in _ngp_batch())
    payload = dict(cfg=dict(mcfg=tngp.NGPConfig(**NGP_KW),
                            rcfg=RenderConfig(**RENDER_KW),
                            tcfg=TrainConfig(**TRAIN_KW)),
                   params=_jax_np(params),
                   batch={"rays_o": ro, "rays_d": rd, "gt": gt}, us=us)
    tmp = tmp_path_factory.mktemp("ranks")
    two = R.start_ranks(R.ngp_dp_job, 2, dict(payload, data=2, model=1),
                        tmp)
    four = R.start_ranks(R.ngp_dp_job, 4, dict(payload, data=2, model=2),
                         tmp)
    jax_runs = {shape: _jax_ngp(shape, params) for shape in ((2, 1), (2, 2))}
    mesh = make_mesh(1, 1, device="cpu")
    single_state = shard_state(R.ngp_state(payload), mesh)
    single = {}
    single["losses"] = R.ngp_steps(single_state, payload, mesh, single)
    two, four = two.wait(), four.wait()
    return {"jax": jax_runs, "single": single,
            "port": {(2, 1): two, (2, 2): four}}


def test_ranks_start_and_hold_equal_state(ngp_runs):
    for shape, ranks in ngp_runs["port"].items():
        assert [r["initialized"] for r in ranks] \
            == [(True, True)] * len(ranks)
        assert all(r["backend"] == "gloo" for r in ranks)
        assert [r["coords"] for r in ranks] == [
            (d, m) for d in range(shape[0]) for m in range(shape[1])]
        # every rank's params, Adam moments, EMA and grid bit for bit
        for r in ranks[1:]:
            assert r["hashes"] == ranks[0]["hashes"]
        assert ranks[0]["losses"] == ranks[-1]["losses"]


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_ngp_dp_step_matches_jax(ngp_runs, shape):
    port = ngp_runs["port"][shape][0]
    want = ngp_runs["jax"][shape]
    np.testing.assert_allclose(port["losses"], want["losses"], rtol=1e-3)
    _leaves_close(port["grads1"], want["grads1"], 5e-2)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_ngp_dp_step_matches_single_rank(ngp_runs, shape):
    port, single = ngp_runs["port"][shape][0], ngp_runs["single"]
    np.testing.assert_allclose(port["losses"], single["losses"], rtol=1e-4)
    _leaves_close(port["grads1"], single["grads1"], 2.0 ** -8)
    for k, p in single["params1"].items():
        g = single["grads1"][k]
        sure = np.abs(g) > 2.0 ** -8 * np.abs(g).max()
        np.testing.assert_allclose(port["params1"][k][sure], p[sure],
                                   rtol=0, atol=2e-5, err_msg=str(k))
        assert sure.any(), k
