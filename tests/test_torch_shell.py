"""The textured bumpy shell (the parity pipeline's scene) in the PyTorch
port vs the JAX package, and the pipeline's h_threshold rule.

- ``shell_radius``, ``shell_texture`` and ``render_gt_shell`` at 24x24 from
  3 poses, with the default focal and a given one: bit for bit (the same
  numpy statements);
- ``SyntheticShellDataset(6, 24, 24)``: poses, images and intrinsics bit
  for bit;
- the h_threshold rule of ``scripts/torch_shell_pipeline.py`` (2 x the
  70th percentile of |sdf| of 2,000 raw vertices to the smoothed
  template, at least 2.5 bump amplitudes) on a fixed bumped icosphere
  with the same numpy draw, vs the JAX test's statements on JAX's
  projector: within 1e-6 (the same nearest-face distances in f32; the
  kNN normal only signs them).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.data import synthetic as jsyn
from nerf_texture_tpu.geometry import projector as jproj
from nerf_texture_tpu.geometry import shape_tools as jshape
from nerf_texture_tpu.geometry.mesh import Mesh as JaxMesh
from nerf_texture_tpu.geometry.mesh import make_icosphere as jax_icosphere
from nerf_texture_tpu_torch.data import synthetic as tsyn
from nerf_texture_tpu_torch.data.poses import orbit_pose
from nerf_texture_tpu_torch.geometry import shape_tools as tshape
from nerf_texture_tpu_torch.geometry.mesh import Mesh
from nerf_texture_tpu_torch.geometry.projector import MeshProjector

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import torch_shell_pipeline as pipe  # noqa: E402

HW = 24
POSES = [orbit_pose(np.pi / 2, 0.0, 2.0), orbit_pose(1.1, 2.3, 2.0),
         orbit_pose(np.pi / 2 + 0.25, 1.234, 2.0)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads beside JAX's pools (as the other test files
    that import both packages)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_shell_fields_match_jax():
    rng = np.random.default_rng(0)
    d = rng.standard_normal((500, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_array_equal(tsyn.shell_radius(d),
                                  jsyn.shell_radius(d))
    np.testing.assert_array_equal(tsyn.shell_radius(d, 0.6, 0.05),
                                  jsyn.shell_radius(d, 0.6, 0.05))
    np.testing.assert_array_equal(tsyn.shell_texture(d),
                                  jsyn.shell_texture(d))
    p = rng.uniform(-0.7, 0.7, (300, 3))
    np.testing.assert_array_equal(tsyn._shell_sdf(p, 0.5, 0.035),
                                  jsyn._shell_sdf(p, 0.5, 0.035))


@pytest.mark.parametrize("focal", [None, 30.0])
def test_render_gt_shell_matches_jax(focal):
    intr = tsyn.sphere_intrinsics(HW, HW, focal)
    lit = 0
    for pose in POSES:
        got = tsyn.render_gt_shell(pose, intr, HW, HW)
        want = jsyn.render_gt_shell(pose, intr, HW, HW)
        assert got.dtype == np.uint8 and got.shape == (HW, HW, 4)
        np.testing.assert_array_equal(got, want)
        lit += int((got[..., 3] > 0).sum())
    assert lit > 0


def test_shell_dataset_matches_jax():
    got = tsyn.SyntheticShellDataset(6, HW, HW)
    want = jsyn.SyntheticShellDataset(6, HW, HW)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.intrinsics, want.intrinsics)
    for k in ("H", "W", "radius", "sphere_radius", "base", "bump_amp",
              "num_frames"):
        assert getattr(got, k) == getattr(want, k), k
    assert isinstance(got, tsyn.SyntheticSphereDataset)


def _bumped_icosphere(make):
    m = make(3, radius=1.0)
    v = np.asarray(m.vertices, np.float64)
    d = v / np.linalg.norm(v, axis=-1, keepdims=True)
    v = (d * tsyn.shell_radius(d)[:, None]).astype(np.float32)
    return v, np.asarray(m.faces)


def test_h_threshold_rule_matches_jax():
    from nerf_texture_tpu.geometry.projector import MeshProjector as JaxMP
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere

    v, f = _bumped_icosphere(make_icosphere)
    vj, fj = _bumped_icosphere(jax_icosphere)
    np.testing.assert_array_equal(v, vj)
    raw_t = tshape.keep_largest_component(Mesh(v, f))
    raw_j = jshape.keep_largest_component(JaxMesh(vj, fj))
    mesh_t = tshape.laplacian_smooth(raw_t, iterations=6)
    mesh_j = jshape.laplacian_smooth(raw_j, iterations=6)
    np.testing.assert_allclose(mesh_t.vertices, mesh_j.vertices, atol=1e-7)
    mp_t = MeshProjector(mesh_t, device="cpu")
    # a floor of 2.5 x 0.004 lets the percentile decide
    got = pipe.h_threshold(raw_t, mp_t, 0.004)
    # the JAX test's statements (tests/test_parity_pipeline.py:138-149)
    mp = JaxMP(mesh_j)
    vr = raw_j.vertices
    pts = jnp.asarray(vr[np.random.default_rng(0).choice(
        len(vr), size=min(2000, len(vr)), replace=False)], jnp.float32)
    sdf = jproj.signed_distance(mp.arrays, pts)[0]
    want = max(float(2.0 * jnp.quantile(jnp.abs(sdf), 0.7)), 2.5 * 0.004)
    assert want > 2.5 * 0.004           # the percentile, not the floor
    assert abs(got - want) <= 1e-6, (got, want)
    # and the floor, where 2.5 amplitudes exceed the percentile
    assert pipe.h_threshold(raw_t, mp_t, 1.0) == 2.5
