"""The NGP's per-corner encoder (``encoder='hash'``) and learned background
sphere (``bg_radius > 0``) in the PyTorch port vs the JAX package, with
parameters converted from the JAX pytree: ``polar_from_ray``, the
converter's trees, ``ngp.background``, ``density`` / ``forward``,
``ngp_background_image`` and whole frames over JAX's params and grid
through both survivor selections.

Tolerances, each with its reason:
- ``polar_from_ray``: 1e-6 (f32 elementwise chains, atan2 / sqrt of two
  libraries);
- converted trees: JAX's shapes and values exactly;
- ``background``, ``density``, ``forward``, ``ngp_background_image``:
  the NGP bounds of tests/test_torch_ngp.py (sigma rtol + atol 1e-2, rgb
  1e-2, geo_feat 2e-2): the MLPs round operands and activations to bf16
  on both sides, and a last-bit difference of an f32 sum can round an
  activation to the neighbouring bf16 value;
- frames: the frame bounds of tests/test_torch_render.py (PSNR >= 45 dB,
  max abs <= 5e-2, live pixels differing <= 0.5%); the composite
  relation image = image(bg=0) + (1 - weights_sum) * bg within 1e-6 (the
  same f32 sums, one frame with the image background and one without).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.ops import polar_from_ray as jax_polar
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train import trainer as jt
from nerf_texture_tpu_torch.convert import params_from_jax
from nerf_texture_tpu_torch.data.poses import orbit_pose
from nerf_texture_tpu_torch.data.synthetic import (shell_occupancy,
                                                   sphere_intrinsics)
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.ops import polar_from_ray
from nerf_texture_tpu_torch.render import renderer as tr
from nerf_texture_tpu_torch.train import trainer as tt

HASH_KW = dict(bound=1.0, num_levels=4, level_dim=2, log2_hashmap_size=12,
               desired_resolution=256, hidden_dim=32, hidden_dim_color=32,
               encoder="hash")
PACKED_KW = dict(bound=1.0, num_levels=4, level_dim=4, log2_bricks=10,
                 desired_resolution=256, hidden_dim=32, hidden_dim_color=32)
PROXY_KW = dict(bound=1.0, cascades=1, grid_size=32, ray_chunk=1024,
                proxy_samples=0, proxy_refined=24, infer_color_cap=4,
                prepass_block=8, prepass_tau_cull=0.1)


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _jax_params(kw, scale=1e4, bg_scale=1e3, seed=0):
    """JAX-initialised params as numpy; the tables scaled so that the
    features vary (init std is 1e-4)."""
    p = jax.tree.map(np.asarray, jngp.init(jax.random.PRNGKey(seed),
                                           jngp.NGPConfig(**kw)))
    p["grid"] = p["grid"] * scale
    if "bg_grid" in p:
        p["bg_grid"] = p["bg_grid"] * bg_scale
    return p


def test_polar_from_ray_matches():
    rng = np.random.default_rng(0)
    o = rng.uniform(-2.5, 2.5, (2000, 3)).astype(np.float32)
    d = _dirs(2000, 1) * rng.uniform(0.5, 2.0, (2000, 1)).astype(np.float32)
    for radius in (4.0, 3.0):
        want = np.asarray(jax_polar(jnp.asarray(o), jnp.asarray(d), radius))
        got = polar_from_ray(torch.from_numpy(o), torch.from_numpy(d),
                             radius).numpy()
        assert got.shape == (2000, 2)
        assert np.abs(want).max() <= 1.0 + 1e-6
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("encoder", ["packed", "hash"])
@pytest.mark.parametrize("bg_radius", [-1.0, 4.0])
def test_converted_and_seeded_trees_have_jax_shapes(encoder, bg_radius):
    kw = dict(HASH_KW if encoder == "hash" else PACKED_KW,
              bg_radius=bg_radius)
    p = _jax_params(kw)
    t = params_from_jax(p, device="cpu")
    s = tngp.init(torch.Generator().manual_seed(0), tngp.NGPConfig(**kw))
    keys = {"grid", "sigma_net", "color_net"} | (
        {"bg_grid", "bg_net"} if bg_radius > 0 else set())
    assert set(t) == set(s) == keys
    for tree in (t, s):
        got = jax.tree.map(lambda a: tuple(a.shape), tree)
        assert got == jax.tree.map(lambda a: a.shape, p)
    for a, b in zip(tt.param_leaves(t), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a.numpy(), b)
    if encoder == "hash":
        spec = tngp.NGPConfig(**kw).grid_spec
        assert t["grid"].shape == (spec.table_size, spec.level_dim)
    if bg_radius > 0:
        assert s["bg_grid"].dtype == torch.float32
        assert float(s["bg_grid"].abs().max()) <= 1e-4


def test_background_matches():
    kw = dict(HASH_KW, bg_radius=4.0)
    p = _jax_params(kw)
    rng = np.random.default_rng(2)
    polar = rng.uniform(-1, 1, (1500, 2)).astype(np.float32)
    d = _dirs(1500, 3)
    want = np.asarray(jngp.background(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(polar), jnp.asarray(d),
                                      jngp.NGPConfig(**kw)))
    got = tngp.background(params_from_jax(p, device="cpu"),
                          torch.from_numpy(polar), torch.from_numpy(d),
                          tngp.NGPConfig(**kw)).numpy()
    assert want.std() > 0.02                  # the colours vary
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def test_hash_density_and_forward_match():
    p = _jax_params(HASH_KW, scale=4e4)
    jcfg, tcfg = jngp.NGPConfig(**HASH_KW), tngp.NGPConfig(**HASH_KW)
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_jax(p, device="cpu")
    x = np.random.default_rng(7).uniform(-1, 1, (1500, 3)).astype(np.float32)
    d = _dirs(1500, 8)
    # the per-corner table is read in f32 whatever table_dtype says
    for jd, td in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        s_j, g_j = jngp.density(pj, jnp.asarray(x), jcfg, table_dtype=jd)
        s_t, g_t = tngp.density(pt, torch.from_numpy(x), tcfg,
                                table_dtype=td)
        s_j = np.asarray(s_j)
        assert s_j.min() < 0.5 and s_j.max() > 2.0      # sigma varies
        np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                                   atol=2e-2)
        fs_j, rgb_j = jngp.forward(pj, jnp.asarray(x), jnp.asarray(d), jcfg,
                                   table_dtype=jd)
        fs_t, rgb_t = tngp.forward(pt, torch.from_numpy(x),
                                   torch.from_numpy(d), tcfg, table_dtype=td)
        np.testing.assert_allclose(fs_t.numpy(), np.asarray(fs_j),
                                   rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0,
                                   atol=1e-2)
    # inference keeps the per-corner table in f32
    assert tt.ngp_infer_params(pt, tcfg) is pt


def test_background_image_matches():
    kw = dict(HASH_KW, bg_radius=4.0)
    p = _jax_params(kw)
    H = W = 24
    intr = sphere_intrinsics(H, W)
    pose = orbit_pose(1.2, 0.7, 2.0)
    want = np.asarray(jt.ngp_background_image(
        jax.tree.map(jnp.asarray, p), jnp.asarray(pose), jnp.asarray(intr),
        H=H, W=W, mcfg=jngp.NGPConfig(**kw)))
    got = tt.ngp_background_image(params_from_jax(p, device="cpu"), pose,
                                  intr, H=H, W=W,
                                  mcfg=tngp.NGPConfig(**kw)).numpy()
    assert got.shape == (H * W, 3) and want.std() > 0.02
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def _frames(kw, **change):
    """The port's render_frame and JAX's render_image (with JAX's
    background image, as its Trainer.render_frame passes it) on JAX's
    params over a shell grid; the port's frame without the background
    too."""
    H = W = 48
    p = _jax_params(kw)
    occ = shell_occupancy(PROXY_KW["grid_size"], device="cpu")
    intr = sphere_intrinsics(H, W)
    pose = orbit_pose(1.2, 0.7, 2.0)
    rcfg = dict(PROXY_KW, **change)
    jm, pj = jngp.NGPConfig(**kw), jax.tree.map(jnp.asarray, p)
    bg = jt.ngp_background_image(pj, jnp.asarray(pose), jnp.asarray(intr),
                                 H=H, W=W, mcfg=jm)
    want = jr.render_image(
        jt.ngp_field_apply, jm, pj, jnp.asarray(occ.occ.numpy()), pose,
        intr, H, W, jr.RenderConfig(**rcfg), bg_color=bg,
        sigma_apply=jt.ngp_sigma_apply, color_apply=jt.ngp_color_apply,
        density=jnp.asarray(occ.density.numpy()))
    tm, pt = tngp.NGPConfig(**kw), params_from_jax(p, device="cpu")
    got = tt.render_frame(pt, occ, pose, intr, H, W, tm,
                          tr.RenderConfig(**rcfg))
    prepass = tr.PrepassState.build(occ.occ, tr.RenderConfig(**rcfg),
                                    density=occ.density)
    fg = tr.render_image(tt.ngp_field_apply, tm, tt.ngp_infer_params(pt, tm),
                         prepass, pose, intr, H, W, tr.RenderConfig(**rcfg),
                         bg_color=0.0, sigma_apply=tt.ngp_sigma_apply,
                         color_apply=tt.ngp_color_apply)
    bg_t = tt.ngp_background_image(pt, pose, intr, H=H, W=W, mcfg=tm)
    return got, want, fg, bg_t.reshape(H, W, 3)


@pytest.mark.parametrize("selection", ["cdf", "topk"])
def test_render_frame_with_background_matches(selection):
    change = {} if selection == "cdf" else dict(infer_cdf=False,
                                                infer_color_cap=8)
    got, want, fg, bg = _frames(dict(HASH_KW, bg_radius=4.0), **change)
    img_t, img_j = got["image"].numpy(), np.asarray(want["image"])
    live_t = got["weights_sum"].numpy() > 0
    live_j = np.asarray(want["weights_sum"]) > 0
    assert 0.05 < live_j.mean() < 0.9 and 0 < got["live"] < 48 * 48
    assert np.mean(live_t != live_j) <= 0.005
    err = np.abs(img_t - img_j)
    assert err.max() <= 5e-2
    assert -10 * np.log10(np.mean(err ** 2) + 1e-20) >= 45.0
    # miss rays show the learned sphere, not a constant
    assert img_t[~live_t].std() > 0.02
    # image = image(bg = 0) + (1 - weights_sum) * bg
    wsum = got["weights_sum"][..., None]
    np.testing.assert_allclose(img_t, (fg["image"] + (1.0 - wsum) * bg)
                               .numpy(), rtol=0, atol=1e-6)


def test_frame_buffer_takes_an_image_background():
    img = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    buf = tr._frame_buffer_packed(img, n=4, device="cpu")
    assert torch.equal(buf[:, :3], img) and not buf[:, 3:].any()
    for bg, want in ((0.25, [0.25] * 3), ([0.1, 0.2, 0.3], [0.1, 0.2, 0.3])):
        buf = tr._frame_buffer_packed(bg, n=4, device="cpu")
        assert torch.equal(buf[:, :3], torch.tensor([want] * 4))


@pytest.mark.parametrize("path", ["pool", "empty_crop", "two_cascades"])
def test_image_background_reaches_every_frame_path(path):
    """An [H * W, 3] background through the pool path, the crop's empty
    frame and the AABB-hit branch of a cascaded grid: every ray that
    composites no weight shows its own pixel of it, and the others
    composite onto it."""
    H = W = 24
    mcfg = tngp.NGPConfig(**HASH_KW)
    params = params_from_jax(_jax_params(HASH_KW), device="cpu")
    rcfg = tr.RenderConfig(**PROXY_KW)
    occ = shell_occupancy(rcfg.grid_size, device="cpu")
    crop = None
    if path == "pool":
        rcfg = dataclasses.replace(rcfg, infer_mode="pool")
    elif path == "empty_crop":
        crop = np.array([0.9, 0.9, 0.9, 1, 1, 1], np.float32)
    else:
        rcfg = dataclasses.replace(rcfg, cascades=2)
        occ = tr.PrepassState.build(torch.cat([occ.occ, occ.occ]), rcfg)
    prepass = (occ if path == "two_cascades" else
               tr.PrepassState.build(occ.occ, rcfg, density=occ.density))
    bg = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (H * W, 3)).astype(np.float32))
    args = (tt.ngp_field_apply, mcfg, params, prepass,
            orbit_pose(1.2, 0.7, 2.0), sphere_intrinsics(H, W), H, W, rcfg)
    kw = dict(sigma_apply=tt.ngp_sigma_apply, color_apply=tt.ngp_color_apply,
              crop_aabb=crop)
    got = tr.render_image(*args, bg_color=bg, **kw)
    fg = tr.render_image(*args, bg_color=0.0, **kw)
    wsum = fg["weights_sum"].reshape(-1, 1)
    img = got["image"].reshape(-1, 3)
    np.testing.assert_allclose(img.numpy(), (fg["image"].reshape(-1, 3)
                                             + (1.0 - wsum) * bg).numpy(),
                               rtol=0, atol=1e-6)
    miss = wsum[:, 0] == 0
    assert miss.any() and torch.equal(img[miss], bg[miss])
    assert (path == "empty_crop") == (got["live"] == 0)
