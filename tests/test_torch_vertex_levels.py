"""The vertex encoder's progressive levels in lockstep with the JAX
package: ``CurvedTrainer`` with ``iters_per_level`` 4 over the three
levels of ``tests/test_torch_vertex_encoder.py``'s setup (a 162-vertex
feature mesh grown to 642, then 2,562 vertices), 12 steps on JAX's draws
with two grid refreshes on JAX's jitter, both trainers advancing their
levels before steps 0, 4 and 8.  At each advance the optimizer slots are
held to optax's: the grown leaf's moments zero, the step count global
(so its bias correction and the LR go on counting), every other leaf's
moments kept.

Tolerances: at each advance the port's lift keeps its old rows exactly
(the lift is tested bit for bit in tests/test_torch_vertex_encoder.py);
the features and their EMA within 2 lr a step taken of JAX's, with the
median within 1e-4; the moments of the other leaves as they were (the
same tensors); the loss as in test_torch_curved_train.py's lockstep
(1e-2 a step over the first refresh cycle, 0.1 at every step, the mean
within 1e-2; tests/test_torch_curved_train.py says why).

The run trains at lr 5e-4, as the camera lockstep of
tests/test_torch_training_steps.py does: Adam turns a near-zero gradient
whose sign differs by rounding into a step of lr either way, and the
vertex features that the rays barely reach do so.
At the curved tests' lr 5e-3 the features part by up to 6.1e-3 after 4
steps and the loss by 0.014-0.066 at three of the 12 steps (measured on
the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_draws import curved_grid_noise
from test_torch_curved_train import _data
from test_torch_vertex_encoder import (HW, make_setup, on_port_grids,
                                       port_state, step_kw, vertex_batch)
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu_torch.data import synthetic as tsyn
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.train import curved_trainer as tct

ITERS_PER_LEVEL = 4
REFRESH = 8
LR = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads a worker for this module (see
    tests/test_torch_training_steps.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grid_noise(key, n, grid_size):
    """The jitter of JAX's refresh without the anchor table (one chunk of
    65,536 cells) from ``key``."""
    return curved_grid_noise(key, n, grid_size, chunk=65536)


def _moments(opt, p):
    s = opt.state[p]
    return s["exp_avg"], s["exp_avg_sq"], float(s["step"])


def test_levels_in_lockstep_with_jax():
    setup = make_setup(iters_per_level=ITERS_PER_LEVEL, lr=LR)
    tj, rj, tcfg = setup["tj"], setup["rj"], setup["tj_cfg"]
    tt = tct.CurvedTrainer(
        tsyn.SyntheticSphereDataset(n_frames=4, H=HW, W=HW), setup["st"],
        setup["ct"], setup["rt"], setup["tt_cfg"], device="cpu")
    tt.state = port_state(setup, tj.state)
    poses, images, intr = _data(setup)
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(7)
    losses_j, losses_t, vnums = [], [], []
    for step in range(12):
        if step % ITERS_PER_LEVEL == 0:
            opt = tt.state.optimizer
            old = tt.state.params["field"]["features_v"]
            others = {id(p): _moments(opt, p)
                      for p in tct.param_leaves(tt.state.params)
                      if p is not old and p in opt.state}
            tj._maybe_update_level(step)
            tt._maybe_update_level(step)
            assert tt.fea_level == tj.fea_level == step // ITERS_PER_LEVEL
            V = tt.ccfg.field.n_feature_vertices
            assert V == tj.ccfg.field.n_feature_vertices
            vnums.append(V)
            # the JAX trainer's grown projector on the port's grid tables
            tj.field_state = tj.field_state._replace(
                projector_fea=on_port_grids(tj.field_state.projector_fea,
                                            tt.field_state.projector_fea))
            np.testing.assert_array_equal(
                tt.field_state.projector_fea.faces.numpy(),
                np.asarray(tj.field_state.projector_fea.faces))
            new = tt.state.params["field"]["features_v"]
            # the lift keeps the old rows; the features follow JAX's
            assert torch.equal(new[:old.shape[0]].detach(), old.detach())
            for ours, theirs in ((new, tj.state.params),
                                 (tt.state.ema_params["field"]["features_v"],
                                  tj.state.ema_params)):
                d = np.abs(ours.detach().numpy()
                           - np.asarray(theirs["field"]["features_v"]))
                assert d.max() <= 2 * tcfg.lr * max(step, 1), d.max()
                assert np.median(d) <= 1e-4, np.median(d)
            adam = tj.state.opt_state[0]
            if step:
                # the grown leaf: zero moments, the global count
                grown = new.shape != old.shape
                m, v, count = _moments(opt, new)
                assert count == int(adam.count) == step == tt.state.step
                mu = np.asarray(adam.mu["field"]["features_v"])
                assert mu.shape == tuple(new.shape)
                if grown:
                    assert not m.any() and not v.any()
                    assert not mu.any()
                else:
                    assert mu.any() and m.any()
                # every other leaf keeps its state
                for p in tct.param_leaves(tt.state.params):
                    if p is new:
                        continue
                    m0, v0, c0 = others[id(p)]
                    m1, v1, c1 = _moments(opt, p)
                    assert m1 is m0 and v1 is v0 and c1 == c0
            assert opt.param_groups[0]["params"] == tct.param_leaves(
                tt.state.params)
        if step % REFRESH == 0:
            key, k = jax.random.split(key)
            near = tj._get_near_cells()
            tj.state = jct.curved_grid_step(
                tj.state, tj.field_state, k, ccfg=tj.ccfg, rcfg=rj,
                near_cells=near, rt=tj.runtime)
            view = dataclasses.replace(
                tt.state, params=tct.curved_infer_params(tt.state.params,
                                                         tt.ccfg))
            tct.curved_grid_step(
                view, tt.field_state,
                [torch.from_numpy(_grid_noise(k, len(near),
                                              rj.grid_size))],
                ccfg=tt.ccfg, rcfg=setup["rt"], near_cells=near,
                rt=tmf.FieldRuntime.default())
            tt.state.occ = view.occ
            np.testing.assert_array_equal(tt.state.occ.occ.numpy(),
                                          np.asarray(tj.state.occ.occ))
        frame = int(rng.integers(0, 4))
        key, k = jax.random.split(key)
        tj.state, mj = jct.curved_train_step(
            tj.state, tj.field_state, tj.poses, tj.images, tj.intrinsics,
            jnp.asarray(frame), k, ccfg=tj.ccfg, rcfg=rj, tcfg=tcfg, H=HW,
            W=HW, rt=tj.runtime)
        mt = tct.curved_train_step(tt.state, vertex_batch(k, frame, tcfg),
                                   tt.field_state, poses, images, intr,
                                   **step_kw(setup, tt.ccfg))
        losses_j.append(float(mj["loss"]))
        losses_t.append(float(mt["loss"]))
    assert vnums == [162, 642, 2562]
    losses_j, losses_t = np.asarray(losses_j), np.asarray(losses_t)
    assert np.isfinite(losses_t).all()
    diff = np.abs(losses_t - losses_j)
    assert diff[:REFRESH].max() <= 1e-2, diff
    assert diff.max() <= 0.1, diff
    assert abs(losses_t.mean() - losses_j.mean()) <= 1e-2
