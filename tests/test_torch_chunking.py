"""Frame chunking in the PyTorch port: every chunk holds ``ray_chunk``
rays, as in the JAX package (its last chunk is padded with the last live
ray), and the guards of deferred shading.

- On frames whose live count is not a multiple of the chunk (the proxy
  path with each selection, the pool path, and the AABB-hit path of a
  two-cascade grid): every call of the chunk's renderer gets exactly
  ``ray_chunk`` rays, one call a chunk, and the frame is held to JAX's
  ``render_image`` at the port's frame bounds (PSNR >= 45 dB, max abs <=
  5e-2, live pixels off <= 0.5%: bf16 rows and activations round
  differently after a last-bit difference).
- Deferred stages with ``anchor_per_sample=False`` on an anchored field
  raise a ``ValueError`` naming both options (the JAX package fails
  there with a TypeError); the paths that ignore ``deferred`` (pool,
  AABB-hit, the band path's chunk-split fallback) warn once each, by
  message, and render the per-sample frame bit for bit.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train.trainer import (ngp_color_apply as jax_color,
                                            ngp_field_apply as jax_field,
                                            ngp_sigma_apply as jax_sigma)
from nerf_texture_tpu_torch.convert import params_from_jax
from nerf_texture_tpu_torch.data.poses import orbit_pose
from nerf_texture_tpu_torch.data.synthetic import (shell_occupancy,
                                                   sphere_intrinsics)
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.ops.occupancy import OccupancyGrid
from nerf_texture_tpu_torch.parallel import make_mesh
from nerf_texture_tpu_torch.parallel.eval import render_image_sharded
from nerf_texture_tpu_torch.render import renderer as tr
from nerf_texture_tpu_torch.train.trainer import (ngp_deferred_s1,
                                                  ngp_deferred_s2,
                                                  ngp_field_apply,
                                                  render_frame)

NGP_KW = dict(bound=1.0, num_levels=4, level_dim=4, log2_bricks=10,
              desired_resolution=256)
RENDER_KW = dict(bound=1.0, cascades=1, grid_size=32, ray_chunk=500,
                 proxy_samples=0, proxy_refined=24, infer_color_cap=4,
                 prepass_block=4, prepass_tau_cull=0.1)
PATHS = {"cdf": {}, "topk": dict(infer_cdf=False, infer_color_cap=8),
         "pool": dict(infer_mode="pool", pool_mean_samples=16,
                      pool_mean_samples_infer=16),
         "aabb": dict(bound=2.0, cascades=2, max_steps=256)}
HW = 48


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads beside JAX's pools (as the other test files
    that import both packages)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _grid(kw):
    """The r = 0.5 shell; at bound 2 in both cascades."""
    if kw["cascades"] == 1:
        return shell_occupancy(kw["grid_size"], device="cpu")
    lv = [shell_occupancy(kw["grid_size"], bound=b, device="cpu")
          for b in (1.0, 2.0)]
    dens = torch.cat([g.density for g in lv])
    return OccupancyGrid(density=dens, occ=(dens.reshape(-1) > 0.01).to(
        torch.uint8), mean_density=dens.mean(),
        iter_density=torch.zeros((), dtype=torch.int32))


def _params(bound):
    jm = jngp.NGPConfig(**dict(NGP_KW, bound=bound))
    p = jax.tree.map(np.asarray, jngp.init(jax.random.PRNGKey(0), jm))
    p["grid"] = p["grid"] * 1e4          # sigma well above and below 1
    return jm, p


@pytest.mark.parametrize("path", list(PATHS))
def test_every_chunk_is_whole_and_the_frame_matches_jax(path, monkeypatch):
    kw = dict(RENDER_KW, **PATHS[path])
    jm, p = _params(kw["bound"])
    occ = _grid(kw)
    intr = sphere_intrinsics(HW, HW)
    pose = orbit_pose(1.2, 0.7, 2.0)
    rows = []
    for name in ("render_rays_proxy", "render_rays"):
        inner = getattr(tr, name)

        def counted(field_fn, first, rays_o, *a, _inner=inner, **k):
            rows.append(rays_o.shape[0])
            return _inner(field_fn, first, rays_o, *a, **k)

        monkeypatch.setattr(tr, name, counted)
    got = render_frame(params_from_jax(p, device="cpu"), occ, pose, intr,
                       HW, HW, tngp.NGPConfig(**dict(NGP_KW,
                                                     bound=kw["bound"])),
                       tr.RenderConfig(**kw))
    chunk = kw["ray_chunk"]
    assert got["chunks"] >= 2 and got["live"] % chunk != 0
    assert got["chunks"] == -(-got["live"] // chunk)
    assert rows == [chunk] * got["chunks"], rows
    want = jr.render_image(
        jax_field, jm, jax.tree.map(jnp.asarray, p),
        jnp.asarray(occ.occ.numpy()), pose, intr, HW, HW,
        jr.RenderConfig(**kw), sigma_apply=jax_sigma, color_apply=jax_color,
        density=jnp.asarray(occ.density.numpy()))
    img_t, img_j = _np(got["image"]), np.asarray(want["image"])
    live_t = _np(got["weights_sum"]) > 0
    live_j = np.asarray(want["weights_sum"]) > 0
    assert 0.05 < live_j.mean() < 0.9
    assert np.mean(live_t != live_j) <= 0.005
    err = np.abs(img_t - img_j)
    assert err.max() <= 5e-2
    assert -10 * np.log10(np.mean(err ** 2) + 1e-20) >= 45.0


def test_deferred_needs_anchor_per_sample():
    """A field whose deferred stage 1 reads anchor frames, with the frames
    computed once a ray: a ValueError naming both options, before any
    rendering (render_rays_proxy and render_image alike)."""
    kw = dict(RENDER_KW, anchor_per_sample=False)
    cfg = tr.RenderConfig(**kw)
    occ = shell_occupancy(kw["grid_size"], device="cpu")

    def fail(*a, **k):
        raise AssertionError("rendered")

    prepass = tr.PrepassState.build(occ.occ, cfg, density=occ.density)
    with pytest.raises(ValueError, match="deferred=True.*anchor_per_sample"):
        tr.render_image(fail, None, None, prepass, orbit_pose(1.2, 0.7, 2.0),
                        sphere_intrinsics(16, 16), 16, 16, cfg,
                        anchor_apply=fail, deferred_apply=(fail, fail))
    rays = torch.zeros((4, 3)), torch.ones((4, 3))
    with pytest.raises(ValueError, match="deferred=True.*anchor_per_sample"):
        tr.render_rays_proxy(fail, prepass.dens8, *rays, torch.zeros(4),
                             torch.ones(4), cfg, anchor_fn=fail,
                             deferred_fns=(fail, fail))


def _ignored_frames(path):
    """(deferred frames twice, the per-sample frame) on a path that
    ignores ``deferred``."""
    kw = dict(RENDER_KW, **PATHS["pool" if path == "pool" else "aabb"])
    _, p = _params(kw["bound"])
    params = params_from_jax(p, device="cpu")
    mcfg = tngp.NGPConfig(**dict(NGP_KW, bound=kw["bound"]))
    occ = _grid(kw)
    cfg = tr.RenderConfig(**kw)
    args = (orbit_pose(1.2, 0.7, 2.0), sphere_intrinsics(24, 24), 24, 24)
    if path == "chunks":
        mesh = make_mesh(1, 1, device="cpu")
        cfg = tr.RenderConfig(**dict(kw, cascades=1, bound=1.0))
        occ = _grid(dict(kw, cascades=1))
        mcfg = tngp.NGPConfig(**NGP_KW)
        params = params_from_jax(_params(1.0)[1], device="cpu")

        def frame(deferred):
            return render_image_sharded(
                ngp_field_apply, mcfg, params, occ.occ, *args, cfg, mesh,
                deferred_apply=((ngp_deferred_s1, ngp_deferred_s2)
                                if deferred else None))
    else:
        def frame(deferred):
            return render_frame(params, occ, *args, mcfg,
                                dataclasses.replace(cfg, deferred=deferred))
    return [frame(True), frame(True)], frame(False)


@pytest.mark.parametrize("path", ["pool", "aabb", "chunks"])
def test_ignored_deferred_warns_once(path):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("default")
        deferred, per_sample = _ignored_frames(path)
    msgs = [str(w.message) for w in rec]
    assert msgs.count(tr.DEFERRED_IGNORED[path]) == 1, msgs
    assert "deferred=True" in tr.DEFERRED_IGNORED[path]
    assert per_sample["live"] > 0
    for out in deferred:
        for k in ("image", "weights_sum"):
            assert torch.equal(out[k], per_sample[k]), k
