"""NGP model pieces in the PyTorch port vs the JAX package, with parameters
converted from the JAX pytree.

Tolerances: trunc_exp within rtol 1e-6 and sh_encode within atol 2e-6
(f32 elementwise chains, different exp implementations); the MLP and the
NGP outputs (sigma, rgb) within 1e-2 -- both round operands and
activations to bf16, and a last-bit difference in an f32 sum can round
an activation to the neighbouring bf16 value (sigma is also held within
rtol 1e-2, since trunc_exp scales an absolute error in h0 by sigma).
geo_feat, a raw layer output of magnitude up to ~3 that no sigmoid
compresses, is held within 2e-2: one bf16 step of a hidden activation of
~2 (2**-7 relative) times a weight of ~0.5 moves it by ~8e-3, and a
sample can take two such steps.

``ngp.density`` on an f32 table (the training read) is held by the share
of samples off by more than 1e-5 relative, at most 1%, for both values
of ``train_table_bf16``: the two sides compute the same products, so
only the order of 27-term sums differs, which moves sigma by ~1e-7
relative, except where that last bit rounds an MLP input to the
neighbouring bf16 value (measured: 1 sample in 2000).  Reading the table
in f32 where JAX reads bf16 rows moves every sample, by up to ~1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.ops import occupancy as jocc
from nerf_texture_tpu.ops.activation import trunc_exp as jax_trunc_exp
from nerf_texture_tpu.ops.encoding import sh_encode as jax_sh_encode
from nerf_texture_tpu.utils.mlp import apply_mlp as jax_apply_mlp
from nerf_texture_tpu_torch.convert import occupancy_from_jax, params_from_jax
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.ops import occupancy as tocc
from nerf_texture_tpu_torch.ops.activation import trunc_exp
from nerf_texture_tpu_torch.ops.encoding import sh_encode
from nerf_texture_tpu_torch.utils.mlp import apply_mlp

NGP_KW = dict(bound=1.0, num_levels=4, level_dim=4, log2_bricks=10,
              desired_resolution=256, hidden_dim=32, hidden_dim_color=32)


def _jax_params(scale=1e4, seed=0):
    """JAX-initialised params as numpy; the table scaled so that the
    features, and so sigma and rgb, vary (init std is 1e-4)."""
    p = jax.tree.map(np.asarray,
                     jngp.init(jax.random.PRNGKey(seed),
                               jngp.NGPConfig(**NGP_KW)))
    p["grid"] = p["grid"] * scale
    return p


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_trunc_exp_forward_and_backward():
    x = np.linspace(-20, 20, 801, dtype=np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = trunc_exp(xt)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jax_trunc_exp(jnp.asarray(x))),
                               rtol=1e-6)
    g = jax.grad(lambda v: jnp.sum(jax_trunc_exp(v)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g), rtol=1e-6)
    assert float(xt.grad[0]) == 0.0 and float(xt.grad[-1]) == 0.0


@pytest.mark.parametrize("degree", [1, 4, 8])
def test_sh_encode_matches(degree):
    d = _dirs(300, degree)
    got = sh_encode(torch.from_numpy(d), degree).numpy()
    want = np.asarray(jax_sh_encode(jnp.asarray(d), degree))
    assert got.shape == (300, degree * degree)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_converter_keeps_structure_and_values():
    p = _jax_params()
    t = params_from_jax(p, device="cpu")
    assert set(t) == {"grid", "sigma_net", "color_net"}
    np.testing.assert_array_equal(t["grid"].numpy(), p["grid"])
    for net in ("sigma_net", "color_net"):
        assert len(t[net]) == len(p[net])
        for lt, lj in zip(t[net], p[net]):
            assert set(lt) == {"w"}
            np.testing.assert_array_equal(lt["w"].numpy(), lj["w"])
    g = jocc.create(8, 1)
    g = g._replace(density=g.density.at[0, 5].set(3.0),
                   occ=g.occ.at[5].set(1), mean_density=jnp.float32(0.25))
    o = occupancy_from_jax(np.asarray(g.density), np.asarray(g.occ),
                           np.asarray(g.mean_density), device="cpu")
    assert o.density.dtype == torch.float32 and o.occ.dtype == torch.uint8
    np.testing.assert_array_equal(o.density.numpy(), np.asarray(g.density))
    np.testing.assert_array_equal(o.occ.numpy(), np.asarray(g.occ))
    assert float(o.mean_density) == 0.25 and o.cascades == 1
    e = tocc.create(8, 1, device="cpu")
    assert e.density.shape == g.density.shape and e.occ.shape == g.occ.shape


def test_init_matches_jax_shapes():
    mcfg = tngp.NGPConfig(**NGP_KW)
    t = tngp.init(torch.Generator().manual_seed(0), mcfg)
    j = _jax_params(scale=1.0)
    assert t["grid"].shape == j["grid"].shape
    for net in ("sigma_net", "color_net"):
        assert [tuple(l["w"].shape) for l in t[net]] == \
            [l["w"].shape for l in j[net]]
    w0 = t["sigma_net"][0]["w"]
    assert abs(float(w0.std()) - np.sqrt(2.0 / w0.shape[0])) < 0.05


def test_apply_mlp_matches():
    p = _jax_params()
    x = np.random.default_rng(3).normal(size=(500, 16)).astype(np.float32)
    layers = p["sigma_net"]
    got = apply_mlp(params_from_jax(layers, device="cpu"),
                    torch.from_numpy(x)).numpy()
    want = np.asarray(jax_apply_mlp(jax.tree.map(jnp.asarray, layers),
                                    jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def test_density_color_forward_match():
    p = _jax_params()
    jcfg, tcfg = jngp.NGPConfig(**NGP_KW), tngp.NGPConfig(**NGP_KW)
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_jax(p, device="cpu")
    x = np.random.default_rng(7).uniform(-1, 1, (800, 3)).astype(np.float32)
    d = _dirs(800, 8)
    for bf16 in (None, "bf16"):
        jd = jnp.bfloat16 if bf16 else None
        td = torch.bfloat16 if bf16 else None
        s_j, g_j = jngp.density(pj, jnp.asarray(x), jcfg, table_dtype=jd)
        s_t, g_t = tngp.density(pt, torch.from_numpy(x), tcfg,
                                table_dtype=td)
        s_j = np.asarray(s_j)
        assert s_j.min() < 0.5 and s_j.max() > 2.0      # sigma varies
        np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                                   atol=2e-2)
        rgb_j = jngp.color(pj, jnp.asarray(d), g_j, jcfg)
        rgb_t = tngp.color(pt, torch.from_numpy(d),
                           torch.tensor(np.asarray(g_j)), tcfg)
        np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j),
                                   rtol=0, atol=1e-2)
        fs_j, frgb_j = jngp.forward(pj, jnp.asarray(x), jnp.asarray(d), jcfg,
                                    table_dtype=jd)
        fs_t, frgb_t = tngp.forward(pt, torch.from_numpy(x),
                                    torch.from_numpy(d), tcfg,
                                    table_dtype=td)
        np.testing.assert_allclose(fs_t.numpy(), np.asarray(fs_j),
                                   rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(frgb_t.numpy(), np.asarray(frgb_j),
                                   rtol=0, atol=1e-2)


@pytest.mark.parametrize("train_table_bf16", [True, False])
def test_density_f32_table_follows_train_table_bf16(train_table_bf16):
    p = _jax_params()
    kw = dict(NGP_KW, train_table_bf16=train_table_bf16)
    x = np.random.default_rng(9).uniform(-1, 1, (2000, 3)).astype(np.float32)
    s_j, g_j = jngp.density(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            jngp.NGPConfig(**kw))
    s_t, g_t = tngp.density(params_from_jax(p, device="cpu"),
                            torch.from_numpy(x), tngp.NGPConfig(**kw))
    s_j, g_j = np.asarray(s_j), np.asarray(g_j)
    assert s_j.min() < 0.5 and s_j.max() > 2.0
    s_off = np.abs(s_t.numpy() - s_j) > 1e-5 * np.abs(s_j) + 1e-6
    g_off = np.any(np.abs(g_t.numpy() - g_j) > 1e-5, axis=-1)
    assert s_off.mean() <= 0.01 and g_off.mean() <= 0.01, \
        (s_off.mean(), g_off.mean())
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=2e-2)


def test_unported_options_raise():
    """The per-corner encoder and the background sphere are ported and
    build, and deferred shading (ported since item 12) renders with them:
    the rays that composite no weight show the sphere."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.data.synthetic import (shell_occupancy,
                                                       sphere_intrinsics)
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train.trainer import (ngp_background_image,
                                                      render_frame)

    mcfg = tngp.NGPConfig(**dict(NGP_KW, encoder="hash", bg_radius=2.0))
    params = tngp.init(torch.Generator(), mcfg)
    assert {"bg_grid", "bg_net"} <= set(params)
    assert tngp.encode_position(params, torch.zeros(2, 3), mcfg).shape == \
        (2, mcfg.grid_spec.output_dim)
    pose, intr = orbit_pose(1.2, 0.7, 2.0), sphere_intrinsics(16, 16)
    out = render_frame(params, shell_occupancy(16, device="cpu"), pose,
                       intr, 16, 16, mcfg,
                       RenderConfig(grid_size=16, deferred=True))
    img = out["image"].reshape(-1, 3)
    assert out["live"] > 0 and bool(torch.isfinite(img).all())
    miss = out["weights_sum"].reshape(-1) == 0
    bg = ngp_background_image(params, pose, intr, H=16, W=16, mcfg=mcfg)
    assert miss.any() and torch.equal(img[miss], bg[miss])
