"""The importance-sampling renderer of the PyTorch port vs the JAX
package's ``render/importance.py``: ``sample_pdf`` with the deterministic
midpoints and with JAX's uniforms, and ``render_rays_importance`` on a
toy field and on converted NGP params, with and without the perturbation
(JAX's jitter and quantiles, drawn from the keys its function splits).

Tolerances, each with its reason:
- ``sample_pdf``: 1e-6 for >= 98% of the positions, and every position
  within 1e-6 + 1e-6 * (bin width) / (bin mass): the same f32 formula,
  but the normalising sum and the cumulative sum add in another order
  (XLA's vectorised reductions), so the CDFs differ by up to ~5e-7, and
  the inverse CDF divides a CDF difference by the mass of the bin a
  quantile falls in (measured 7.6e-6 in bins of 1% of the mass);
- ``render_rays_importance`` on the toy field: 1e-4 -- the positions
  agree as above, the field is smooth, the composite sums 256 samples;
- on the NGP: 1e-4 for >= 95% of the values and the NGP bound of
  1e-2 for all: the MLPs round activations to bf16 on both sides, and a
  last-bit difference can round one to the neighbouring bf16 value
  (measured: 98.7% within 1e-4, the largest 6.6e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.render import importance as jimp
from nerf_texture_tpu_torch.convert import params_from_jax
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.render import importance as timp

R0 = 0.5


def _toy_jax(x, d):
    r = jnp.linalg.norm(x, axis=-1)
    sigma = 40.0 * jnp.exp(-((r - R0) / 0.08) ** 2)
    return sigma, (x / jnp.maximum(r[..., None], 1e-6) + 1.0) / 2.0


def _toy_torch(x, d):
    r = torch.linalg.norm(x, dim=-1)
    sigma = 40.0 * torch.exp(-((r - R0) / 0.08) ** 2)
    return sigma, (x / torch.clamp(r[..., None], min=1e-6) + 1.0) / 2.0


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = np.tile([[0.05, -0.02, -2.0]], (n, 1)).astype(np.float32)
    d = rng.normal(size=(n, 3)) * [0.3, 0.3, 0] + [0, 0, 1]
    o[:3] = [[0.0, 3.0, 0.0]] * 3               # misses of the cube
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d[:3] = [[1.0, 0.0, 0.0]] * 3
    return o, d.astype(np.float32)


def _sorted_bins(n, t, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(0.5, 3.5, (n, t)), -1).astype(np.float32)


@pytest.mark.parametrize("random_u", [False, True])
def test_sample_pdf_matches(random_u):
    rng = np.random.default_rng(1)
    bins = _sorted_bins(300, 33, 2)
    w = rng.uniform(0, 1, (300, 32)).astype(np.float32) ** 4
    w[:20] = 0.0                                 # all-empty rays
    w[20:40, 5] = 30.0                           # one dominant bin
    key = jax.random.PRNGKey(3) if random_u else None
    want = np.asarray(jimp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 64,
                                      key=key))
    u = (torch.from_numpy(np.asarray(jax.random.uniform(key, (300, 64))))
         if random_u else None)
    got = timp.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 64,
                          u=u).numpy()
    assert got.shape == (300, 64)
    assert (got >= bins[:, :1] - 1e-6).all()
    assert (got <= bins[:, -1:] + 1e-6).all()
    # the inverse CDF maps a CDF difference e to a position difference of
    # e * (bin width) / (bin mass): where a quantile falls in a bin of
    # little mass, a CDF 1e-6 apart moves it further
    wj = w + 1e-5
    cdf = np.concatenate([np.zeros((300, 1)), np.cumsum(
        wj / wj.sum(-1, keepdims=True), -1)], -1)
    i = np.clip(np.stack([np.searchsorted(c, q, side="right") for c, q in
                          zip(cdf, u.numpy() if random_u else
                              np.broadcast_to(np.linspace(
                                  0.5 / 64, 1 - 0.5 / 64, 64), (300, 64)))]),
                1, 32)
    mass = np.take_along_axis(np.diff(cdf, axis=-1), i - 1, -1)
    width = np.take_along_axis(np.diff(bins, axis=-1), i - 1, -1)
    bound = 1e-6 + 1e-6 * width / np.maximum(mass, 1e-5)
    err = np.abs(got - want)
    assert (err <= bound).all(), float((err / bound).max())
    assert np.mean(err <= 1e-6) >= 0.98


def _draws(key, n, num_steps, upsample_steps):
    """The jitter and quantiles JAX's render_rays_importance draws."""
    k1, k2 = jax.random.split(key)
    jit = np.asarray(jax.random.uniform(k1, (n, num_steps)))
    u = np.asarray(jax.random.uniform(k2, (n, upsample_steps)))
    return torch.from_numpy(jit), torch.from_numpy(u)


@pytest.mark.parametrize("perturb", [False, True])
def test_render_rays_importance_matches_on_toy_field(perturb):
    o, d = _rays(256, 4)
    key = jax.random.PRNGKey(5)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    want = jimp.render_rays_importance(
        lambda x: _toy_jax(x, None)[0], _toy_jax, jnp.asarray(o),
        jnp.asarray(d), perturb=perturb, key=key, bg_color=jnp.asarray(bg))
    jitter, u = _draws(key, 256, 128, 128)
    got = timp.render_rays_importance(
        lambda x: _toy_torch(x, None)[0], _toy_torch, torch.from_numpy(o),
        torch.from_numpy(d), perturb=perturb, jitter=jitter, u=u,
        bg_color=torch.from_numpy(bg))
    ws = np.asarray(want["weights_sum"])
    assert (ws > 0.95).mean() > 0.3 and (ws < 0.05).mean() > 0.05
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    # the misses show the background
    np.testing.assert_allclose(got["image"][:3].numpy(), [bg] * 3, atol=1e-7)


@pytest.mark.parametrize("perturb", [False, True])
def test_render_rays_importance_matches_on_ngp(perturb):
    kw = dict(bound=1.0, num_levels=4, level_dim=2, log2_hashmap_size=12,
              desired_resolution=256, hidden_dim=32, hidden_dim_color=32,
              encoder="hash")
    p = jax.tree.map(np.asarray, jngp.init(jax.random.PRNGKey(0),
                                           jngp.NGPConfig(**kw)))
    p["grid"] = p["grid"] * 4e4
    jm, tm = jngp.NGPConfig(**kw), tngp.NGPConfig(**kw)
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_jax(p, device="cpu")
    o, d = _rays(128, 6)
    key = jax.random.PRNGKey(7)
    want = jimp.render_rays_importance(
        lambda x: jngp.density(pj, x, jm)[0],
        lambda x, dd: jngp.forward(pj, x, dd, jm), jnp.asarray(o),
        jnp.asarray(d), num_steps=32, upsample_steps=32, perturb=perturb,
        key=key)
    jitter, u = _draws(key, 128, 32, 32)
    got = timp.render_rays_importance(
        lambda x: tngp.density(pt, x, tm)[0],
        lambda x, dd: tngp.forward(pt, x, dd, tm), torch.from_numpy(o),
        torch.from_numpy(d), num_steps=32, upsample_steps=32,
        perturb=perturb, jitter=jitter, u=u)
    ws = np.asarray(want["weights_sum"])
    assert ws.max() > 0.5 and ws.std() > 0.05
    for k in ("image", "weights_sum", "depth"):
        err = np.abs(got[k].numpy() - np.asarray(want[k]))
        assert err.max() <= 1e-2 and np.mean(err <= 1e-4) >= 0.95, \
            (k, float(err.max()), float(np.mean(err <= 1e-4)))
