"""The proxy inference renderer of the PyTorch port vs the JAX package,
piece by piece and as the whole NGP serving slice.

Tolerances, each with its reason:
- integer and boolean results (corner table, AABB, dilated grid, live
  sets, 3x3 max) exactly;
- rays, slab test, proxy density and prepass windows within 1e-5 (f32
  elementwise chains; t values are O(1));
- render_rays_proxy on a toy field within 1e-4, with either selection
  and with two rounds (``proxy_samples=32``, round 2 by top-k): the
  survivor t's agree within 1e-5 (test_torch_proxy_select.py) and the
  field is smooth;
- the whole slice (image), with either selection and with two rounds:
  PSNR >= 45 dB, max abs
  error <= 5e-2, live pixels differing <= 0.5% -- both sides round MLP
  activations and table products to bf16, a last-bit difference can
  round to the neighbouring bf16 value, and a prepass hit test on a cell
  border can flip a block.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.data.rays import get_rays as jax_get_rays
from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.ops.marching import near_far_from_aabb as jax_near_far
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train.trainer import ngp_color_apply as jax_color_apply
from nerf_texture_tpu.train.trainer import ngp_field_apply as jax_field_apply
from nerf_texture_tpu.train.trainer import ngp_sigma_apply as jax_sigma_apply
from nerf_texture_tpu_torch.convert import params_from_jax
from nerf_texture_tpu_torch.data.poses import orbit_pose
from nerf_texture_tpu_torch.data.rays import get_rays
from nerf_texture_tpu_torch.data.synthetic import (shell_occupancy,
                                                   sphere_intrinsics)
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.ops.marching import near_far_from_aabb
from nerf_texture_tpu_torch.render import renderer as tr
from nerf_texture_tpu_torch.train.trainer import render_frame

R0 = 0.5
PROXY_KW = dict(bound=1.0, cascades=1, proxy_samples=0, proxy_refined=24,
                infer_color_cap=4, prepass_block=8, prepass_tau_cull=0.1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _toy_field_jax(x, d):
    r = jnp.linalg.norm(x, axis=-1)
    sigma = 60.0 * jnp.exp(-((r - R0) / 0.06) ** 2)
    return sigma, (x / jnp.maximum(r[..., None], 1e-6) + 1.0) / 2.0


def _toy_field_torch(x, d):
    r = torch.linalg.norm(x, dim=-1)
    sigma = 60.0 * torch.exp(-((r - R0) / 0.06) ** 2)
    return sigma, (x / torch.clamp(r[..., None], min=1e-6) + 1.0) / 2.0


def _toy_density(H):
    c = (np.arange(H, dtype=np.float32) + 0.5) / H * 2.0 - 1.0
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt(xx ** 2 + yy ** 2 + zz ** 2)
    dens = (60.0 * np.exp(-((r - R0) / 0.06) ** 2)).astype(np.float32)
    dens[dens < 1e-30] = 0.0      # XLA:CPU flushes denormals, torch not
    return dens.reshape(1, -1)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = np.tile([[0.05, -0.02, -2.0]], (n, 1)).astype(np.float32)
    d = rng.normal(size=(n, 3)) * [0.25, 0.25, 0] + [0, 0, 1]
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def test_rays_and_slab_test_match():
    pose = orbit_pose(1.1, 0.4, 2.0)
    intr = sphere_intrinsics(24, 20)
    a = get_rays(_t(pose), _t(intr), 24, 20)
    b = jax_get_rays(jnp.asarray(pose), jnp.asarray(intr), 24, 20)
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(_np(a[k]), np.asarray(b[k]), rtol=0,
                                   atol=1e-6)
    inds = np.array([3, 77, 400, 479])
    a = get_rays(_t(pose), _t(intr), 24, 20, inds=_t(inds))
    b = jax_get_rays(jnp.asarray(pose), jnp.asarray(intr), 24, 20,
                     inds=jnp.asarray(inds))
    np.testing.assert_allclose(_np(a["rays_d"]), np.asarray(b["rays_d"]),
                               rtol=0, atol=1e-6)
    aabb = np.array([-0.6, -0.5, -0.6, 0.6, 0.55, 0.6], np.float32)
    o, d = _rays(300, 0)
    d[:3] = [[1, 0, 0], [0, 1, 0], [0, 0, 1]]      # axis-parallel rays
    n_t, f_t = near_far_from_aabb(_t(o), _t(d), _t(aabb), 0.2)
    n_j, f_j = jax_near_far(jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(aabb), 0.2)
    np.testing.assert_allclose(_np(n_t), np.asarray(n_j), atol=1e-5)
    np.testing.assert_allclose(_np(f_t), np.asarray(f_j), atol=1e-5)
    assert (_np(f_t) > _np(n_t)).any() and (_np(f_t) == 0).any()


def test_corner_table_and_proxy_sigma_match():
    H = 16
    dens = _toy_density(H)
    dens[0, :50] = -1.0                           # untrained cells clamp
    d8_t = tr.density_corner_table(_t(dens), H)
    d8_j = jr.density_corner_table(jnp.asarray(dens), H)
    np.testing.assert_array_equal(_np(d8_t), np.asarray(d8_j))
    o, d = _rays(64, 1)
    ts = np.linspace(0.5, 3.5, 24, dtype=np.float32)[None].repeat(64, 0)
    s_t = tr._proxy_sigma(d8_t, _t(o), _t(d), _t(ts), H, 1.0)
    s_j = jr._proxy_sigma(d8_j, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(ts), H, 1.0)
    np.testing.assert_allclose(_np(s_t), np.asarray(s_j), rtol=1e-5,
                               atol=1e-5)


def _toy_proxy_render(**change):
    """render_rays_proxy of both packages on the toy shell field."""
    H = 32
    dens = _toy_density(H)
    o, d = _rays(200, 2)
    aabb = np.array([-0.6] * 3 + [0.6] * 3, np.float32)
    n_j, f_j = jax_near_far(jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(aabb), 0.2)
    kw = dict(PROXY_KW, grid_size=H, **change)
    out_j = jr.render_rays_proxy(
        _toy_field_jax, jr.density_corner_table(jnp.asarray(dens), H),
        jnp.asarray(o), jnp.asarray(d), n_j, f_j, jr.RenderConfig(**kw))
    out_t = tr.render_rays_proxy(
        _toy_field_torch, tr.density_corner_table(_t(dens), H), _t(o),
        _t(d), _t(n_j), _t(f_j), tr.RenderConfig(**kw))
    return out_t, out_j


def _assert_proxy_render_close(out_t, out_j):
    assert float(out_t["weights_sum"].max()) > 0.9   # rays hit the shell
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(_np(out_t[k]), np.asarray(out_j[k]),
                                   rtol=0, atol=1e-4)
    np.testing.assert_array_equal(_np(out_t["counts"]),
                                  np.asarray(out_j["counts"]))


def test_render_rays_proxy_matches_on_toy_field():
    _assert_proxy_render_close(*_toy_proxy_render())


def test_render_rays_proxy_topk_matches_on_toy_field():
    out_t, out_j = _toy_proxy_render(infer_cdf=False, infer_color_cap=8)
    _assert_proxy_render_close(out_t, out_j)
    assert int(_np(out_t["counts"]).max()) == 8


def test_render_rays_proxy_two_round_matches_on_toy_field():
    """The default RenderConfig's two rounds: 32 coarse samples narrow
    the span, round 2 takes the top-8 of 24 (JAX's XLA chain); the
    inverse-CDF flag does not apply, and no warning is given."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out_t, out_j = _toy_proxy_render(proxy_samples=32, infer_color_cap=8)
    _assert_proxy_render_close(out_t, out_j)
    assert int(_np(out_t["counts"]).max()) == 8
    # round 1 narrowed the span: the survivors differ from one round's
    one_t, _ = _toy_proxy_render(infer_cdf=False, infer_color_cap=8)
    assert not torch.equal(out_t["depth"], one_t["depth"])


def test_proxy_pallas_off_takes_topk_and_warns():
    with pytest.warns(UserWarning, match="requires proxy_pallas"):
        off_t, off_j = _toy_proxy_render(proxy_pallas=False,
                                         infer_color_cap=8)
    topk_t, _ = _toy_proxy_render(infer_cdf=False, infer_color_cap=8)
    for k in ("image", "depth", "weights_sum", "counts"):
        assert torch.equal(off_t[k], topk_t[k])
    # JAX's XLA chain (jnp.cumsum) has the Pallas kernel's semantics
    _assert_proxy_render_close(off_t, off_j)


@pytest.mark.parametrize("grid", [32, 64])
def test_prepass_arrays_match(grid):
    occ = shell_occupancy(grid, device="cpu")
    dens = occ.density.numpy().copy()
    rng = np.random.default_rng(grid)
    salt = rng.choice(dens.shape[1], 40, replace=False)
    dens[0, salt] = 0.1     # isolated salt cells, below the strong bound
    cfg = dict(grid_size=grid, **PROXY_KW)
    occ_np = (dens[0] > 0.01).astype(np.uint8)
    a_t, dil_t = tr._occ_prepass_arrays(_t(occ_np), tr.RenderConfig(**cfg),
                                        density=_t(dens))
    a_j, dil_j = jr._occ_prepass_arrays(jnp.asarray(occ_np),
                                        jr.RenderConfig(**cfg),
                                        density=jnp.asarray(dens))
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(dil_t, np.asarray(dil_j))
    # the filter removed the salt: the dilated grid is not the raw one's
    raw = jr._dilate_occ(occ_np, grid, 1)
    assert dil_t.sum() < raw.sum()


def _prepass_inputs(grid, H, W, B, pose):
    occ = shell_occupancy(grid, device="cpu")
    cfg = tr.RenderConfig(grid_size=grid, **PROXY_KW)
    st = tr.PrepassState.build(occ.occ, cfg, density=occ.density)
    intr_b = sphere_intrinsics(H, W) / B
    Hb, Wb = -(-H // B), -(-W // B)
    rays = jax_get_rays(jnp.asarray(pose), jnp.asarray(intr_b), Hb, Wb)
    return cfg, st, rays, Hb, Wb


@pytest.mark.parametrize("H,W,B", [(64, 64, 8), (60, 52, 8), (32, 32, 1)])
def test_prepass_compact_matches(H, W, B):
    grid = 32
    pose = orbit_pose(1.3, 0.9, 2.0)
    cfg, st, rays, Hb, Wb = _prepass_inputs(grid, H, W, B, pose)
    nb = Hb * Wb
    kw = dict(grid_size=grid, margin_steps=cfg.prepass_margin_steps
              if B > 1 else 0.0, H=H, W=W, Hb=Hb, Wb=Wb, B=B, nb=nb,
              tau_cull=cfg.prepass_tau_cull, tau_samples=st.tau_samples)
    perm_j, cnt_j, t0_j, t1_j = jr._prepass_compact(
        rays["rays_o"], rays["rays_d"], jnp.asarray(_np(st.occ_dil)),
        jnp.asarray(st.aabb_np), 1.0, 0.2, block=8192,
        dens8=jnp.asarray(_np(st.dens8)), **kw)
    perm_t, cnt_t, t0_t, t1_t, n_hit = tr._prepass_compact(
        _t(rays["rays_o"]), _t(rays["rays_d"]), st.occ_dil, st.aabb, 1.0,
        0.2, dens8=st.dens8, **kw)
    cnt = int(cnt_j)
    assert int(cnt_t) == cnt and 0 < cnt < H * W
    assert 0 < int(n_hit) <= nb
    assert set(_np(perm_t)[:cnt].tolist()) == \
        set(np.asarray(perm_j)[:cnt].tolist())
    np.testing.assert_allclose(_np(t0_t), np.asarray(t0_j)[:nb], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(_np(t1_t), np.asarray(t1_j)[:nb], rtol=0,
                               atol=1e-5)


def test_live_permutation_and_max3x3_match():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (7, 9)).astype(np.float32)
    np.testing.assert_array_equal(_np(tr._max3x3(_t(x))),
                                  np.asarray(jr._max3x3(jnp.asarray(x))))
    for H, W, B in [(64, 48, 8), (30, 22, 4), (10, 10, 1)]:
        Hb, Wb = -(-H // B), -(-W // B)
        hit = rng.uniform(size=Hb * Wb) < 0.3
        kw = dict(H=H, W=W, Hb=Hb, Wb=Wb, B=B, nb=Hb * Wb)
        p_t, c_t = tr._live_permutation(_t(hit), **kw)
        p_j, c_j = jr._live_permutation(jnp.asarray(hit), **kw)
        c = int(c_j)
        assert int(c_t) == c > 0
        assert set(_np(p_t)[:c].tolist()) == set(np.asarray(p_j)[:c].tolist())
        assert sorted(_np(p_t).tolist()) == list(range(H * W))


# ---------------------------------------------------------------------------
# the whole slice: render_frame (port) vs render_image (JAX)
# ---------------------------------------------------------------------------

NGP_KW = dict(bound=1.0, num_levels=4, level_dim=4, log2_bricks=10,
              desired_resolution=256)
SLICE_RENDER = dict(grid_size=32, ray_chunk=1024, **PROXY_KW)


def _whole_slice(**change):
    H = W = 64
    jm = jngp.NGPConfig(**NGP_KW)
    p = jax.tree.map(np.asarray, jngp.init(jax.random.PRNGKey(0), jm))
    p["grid"] = p["grid"] * 1e4          # sigma well above and below 1
    occ = shell_occupancy(SLICE_RENDER["grid_size"], device="cpu")
    intr = sphere_intrinsics(H, W)
    pose = orbit_pose(1.2, 0.7, 2.0)     # not a training pose
    kw = dict(SLICE_RENDER, **change)
    want = jr.render_image(
        jax_field_apply, jm, jax.tree.map(jnp.asarray, p),
        jnp.asarray(occ.occ.numpy()), pose, intr, H, W,
        jr.RenderConfig(**kw), sigma_apply=jax_sigma_apply,
        color_apply=jax_color_apply,
        density=jnp.asarray(occ.density.numpy()))
    got = render_frame(params_from_jax(p, device="cpu"), occ, pose, intr, H, W,
                       tngp.NGPConfig(**NGP_KW), tr.RenderConfig(**kw))
    img_t, img_j = _np(got["image"]), np.asarray(want["image"])
    assert img_t.shape == (H, W, 3)
    live_t = _np(got["weights_sum"]) > 0
    live_j = np.asarray(want["weights_sum"]) > 0
    assert 0 < got["live"] < H * W and got["chunks"] >= 2
    assert 0.05 < live_j.mean() < 0.9
    assert np.mean(live_t != live_j) <= 0.005
    err = np.abs(img_t - img_j)
    assert err.max() <= 5e-2
    assert -10 * np.log10(np.mean(err ** 2) + 1e-20) >= 45.0
    np.testing.assert_allclose(_np(got["depth"]), np.asarray(want["depth"]),
                               rtol=0, atol=5e-2)


def test_whole_slice_matches_jax_render_image():
    _whole_slice()


def test_whole_slice_topk_matches_jax_render_image():
    _whole_slice(infer_cdf=False, infer_color_cap=8)


def test_whole_slice_two_round_matches_jax_render_image():
    """The slice at the default RenderConfig's selection: two rounds,
    proxy_samples 32, top-8 of 24."""
    _whole_slice(proxy_samples=32, infer_color_cap=8)


def test_empty_grid_renders_background():
    occ = shell_occupancy(16, sigma=0.0, device="cpu")
    cfg = tr.RenderConfig(grid_size=16, **PROXY_KW)
    mcfg = tngp.NGPConfig(**NGP_KW)
    params = tngp.init(torch.Generator().manual_seed(0), mcfg)
    out = render_frame(params, occ, orbit_pose(1.2, 0.7, 2.0),
                       sphere_intrinsics(16, 16), 16, 16, mcfg, cfg,
                       bg_color=0.25)
    assert torch.equal(out["image"], torch.full((16, 16, 3), 0.25))


def test_unported_branches_raise():
    occ = shell_occupancy(16, device="cpu")
    intr = sphere_intrinsics(16, 16)
    pose = orbit_pose(1.2, 0.7, 2.0)
    mcfg = tngp.NGPConfig(**NGP_KW)
    params = tngp.init(torch.Generator().manual_seed(0), mcfg)
    base = tr.RenderConfig(grid_size=16, **PROXY_KW)
    # the two-round proxy is ported: the default RenderConfig renders
    out = render_frame(params, occ, pose, intr, 16, 16, mcfg,
                       dataclasses.replace(base, proxy_samples=32))
    assert bool(torch.isfinite(out["image"]).all())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render_frame(params, occ, pose, intr, 16, 16, mcfg,
                     dataclasses.replace(base, deferred=True))
    two_cascades = dataclasses.replace(base, cascades=2)
    prepass = tr.PrepassState.build(torch.cat([occ.occ, occ.occ]),
                                    two_cascades)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render_frame(params, None, pose, intr, 16, 16, mcfg, two_cascades,
                     prepass=prepass)
    # without the density grid there is no corner table: the pool path
    no_density = tr.PrepassState.build(occ.occ, base)
    assert no_density.dens8 is None
    out = render_frame(params, None, pose, intr, 16, 16, mcfg, base,
                       prepass=no_density)
    assert out["chunks"] >= 1 and bool(torch.isfinite(out["image"]).all())


def test_tau_sweep_cap_warns():
    # every block of a 6400-block frame hits a fully occupied grid
    occ = shell_occupancy(8, radius=0.0, half_width_cells=100.0,
                          device="cpu")
    cfg = tr.RenderConfig(grid_size=8, **dict(PROXY_KW, prepass_block=2))
    st = tr.PrepassState.build(occ.occ, cfg, density=occ.density)

    def field(params, x, d, static):
        return _toy_field_torch(x, d)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = tr.render_image(field, None, None, st,
                              orbit_pose(1.2, 0.7, 2.0),
                              sphere_intrinsics(160, 160), 160, 160, cfg)
    assert any("cap of 4096" in str(w.message) for w in caught)
    assert out["live"] > 4096 * 4
    assert bool(torch.isfinite(out["image"]).all())
