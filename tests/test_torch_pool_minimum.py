"""The minimum pixel of trained curved pool frames (``parity=True``) in
the PyTorch port vs the JAX package, on the same trained params and grid
at the curved test width (``tests/test_torch_curved_render.py``'s
configs): JAX's ``CurvedTrainer`` trains 60 steps, the port renders with
its params, EMA and grid converted.

A pool frame composites ``image + (1 - weights_sum) * bg``, its
transmittance a difference of one f32 running sum of sigma * dt over the
chunk's whole sample pool in both packages
(``render/compact.py::flat_weights``), so a ray's ``weights_sum`` can
pass 1 by the sum's rounding and its pixel go below 0.  Tolerances: the
minimum pixel of each frame within 1e-4 of JAX's (the frames agree
within tests/test_torch_curved_render.py's bounds; bf16 activations can
round to a neighbouring value after a last-bit difference), and a frame
goes negative in the port exactly when it does in JAX.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu.geometry.mesh import make_icosphere as jax_icosphere
from nerf_texture_tpu.geometry.projector import (
    MeshProjector as JaxMeshProjector)
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.models.curved_field import (
    CurvedFieldConfig as JaxCurvedFieldConfig)
from nerf_texture_tpu.models.mesh_field import (
    MeshFieldConfig as JaxMeshFieldConfig)
from nerf_texture_tpu.render.renderer import RenderConfig as JaxRenderConfig
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu_torch.convert import occupancy_from_jax, params_from_jax
from nerf_texture_tpu_torch.data import synthetic as tsyn
from nerf_texture_tpu_torch.data.poses import orbit_pose
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
from nerf_texture_tpu_torch.geometry.projector import MeshProjector
from nerf_texture_tpu_torch.models import mesh_field
from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train import curved_trainer as tct

FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=False)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
RENDER = dict(bound=1.0, cascades=1, grid_size=16, max_steps=48,
              max_samples_train=24, max_samples_infer=32, ray_chunk=256,
              pool_mean_samples=16, pool_mean_samples_infer=16,
              proxy_samples=0)
TRAIN = dict(lr=5e-3, total_steps=200, num_rays=256, grid_update_interval=8)
HW = 48
STEPS = 60


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained():
    rj = JaxRenderConfig(**RENDER)
    ds = SyntheticSphereDataset(n_frames=4, H=HW, W=HW)
    tj = jct.CurvedTrainer(
        ds, jmf.make_state(JaxMeshProjector(jax_icosphere(2, radius=0.5))),
        JaxCurvedFieldConfig(field=JaxMeshFieldConfig(**FIELD), **MODEL), rj,
        jct.CurvedTrainConfig(**TRAIN), key=jax.random.PRNGKey(0))
    tj.initialize_states(1)
    tj.train(STEPS)
    tt = tct.CurvedTrainer(
        tsyn.SyntheticSphereDataset(n_frames=4, H=HW, W=HW),
        mesh_field.make_state(MeshProjector(make_icosphere(2, radius=0.5),
                                            device="cpu")),
        CurvedFieldConfig(field=MeshFieldConfig(**FIELD), **MODEL),
        RenderConfig(**dataclasses.asdict(rj)),
        tct.CurvedTrainConfig(**TRAIN), device="cpu")
    to_np = lambda t: jax.tree.map(np.asarray, t)       # noqa: E731
    tt.state.params = params_from_jax(to_np(tj.state.params), device="cpu")
    tt.state.ema_params = params_from_jax(to_np(tj.state.ema_params),
                                          device="cpu")
    o = tj.state.occ
    tt.state.occ = occupancy_from_jax(o.density, o.occ, o.mean_density,
                                      o.iter_density, device="cpu")
    return tj, tt


@pytest.mark.parametrize("use_ema", [False, True])
def test_pool_frame_minimum_matches_jax(trained, use_ema):
    tj, tt = trained
    for pose in (np.asarray(tj.dataset.poses[1]),
                 orbit_pose(np.pi / 2 + 0.2, 0.3, 2.0)):
        want = np.asarray(tj.render_frame(pose, use_ema=use_ema,
                                          parity=True)["image"])
        got = tt.render_frame(pose, use_ema=use_ema,
                              parity=True)["image"].numpy()
        assert np.isfinite(got).all() and got.shape == (HW, HW, 3)
        assert got.std() > 1e-2                       # a trained frame
        assert abs(float(got.min()) - float(want.min())) <= 1e-4, \
            (float(got.min()), float(want.min()))
        assert (got.min() < 0) == (want.min() < 0)
