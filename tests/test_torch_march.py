"""Occupancy march, compositing and the compacted sample pool of the
PyTorch port vs the JAX package, on seeded numpy inputs.

Tolerances, each with its reason:
- integers and masks (counts, mask, ray ids, offsets, validity) exactly;
- t values and step sizes within 1e-6 (the same f32 affine chain);
- dense compositing within 1e-6 (short per-ray cumsums);
- pool compositing and segment sums within 2e-5 (absolute, and relative
  for the depth, a sum of w * t with t ~ 2): the pool's transmittance
  is a global cumsum over all M samples minus each segment's start, and
  the two packages accumulate that cumsum differently (PyTorch's CPU
  cumsum in f64, XLA's in f32), so a ray deep in the pool sees its
  optical depth move by ~1e-6 of the running total.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.ops import composite as jc
from nerf_texture_tpu.ops import marching as jm
from nerf_texture_tpu.render import compact as jcp
from nerf_texture_tpu_torch.ops import composite as tc
from nerf_texture_tpu_torch.ops import marching as tm
from nerf_texture_tpu_torch.render import compact as tcp

GRID = 16
MARCH = dict(bound=1.0, cascades=1, grid_size=GRID, max_steps=96,
             max_samples=24)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _scene(seed, n=64):
    """Rays from outside the cube through it, a ~40% occupied grid."""
    rng = np.random.default_rng(seed)
    occ = (rng.uniform(size=GRID ** 3) < 0.4).astype(np.uint8)
    o = np.tile([[0.1, -0.05, -2.2]], (n, 1)).astype(np.float32)
    d = rng.normal(size=(n, 3)) * [0.3, 0.3, 0] + [0, 0, 1]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[:3] = [[0, 1, 0], [0.6, 0.0, 0.8], [0, 0, 1]]    # one ray misses
    o[0] = [0.0, 1.5, -2.0]
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    nears, fars = jm.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(aabb), 0.2)
    return occ, o, d, np.asarray(nears), np.asarray(fars)


def _march_both(seed, perturb):
    occ, o, d, nears, fars = _scene(seed)
    key = jax.random.PRNGKey(seed)
    want = jm.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(occ),
                         jnp.asarray(nears), jnp.asarray(fars),
                         perturb=perturb, key=key, **MARCH)
    # the jitter JAX drew from its key inside march_rays
    u = np.asarray(jax.random.uniform(key, (o.shape[0],), jnp.float32))
    got = tm.march_rays(_t(o), _t(d), _t(occ), _t(nears), _t(fars),
                        perturb=perturb, u=_t(u) if perturb else None,
                        **MARCH)
    return got, want


@pytest.mark.parametrize("perturb", [False, True])
def test_march_rays_matches(perturb):
    got, want = _march_both(0, perturb)
    counts = _np(want.counts)
    assert counts[0] == 0 and counts.max() == MARCH["max_samples"]
    assert 0 < np.median(counts) < MARCH["max_samples"]
    np.testing.assert_array_equal(_np(got.counts), counts)
    np.testing.assert_array_equal(_np(got.mask), _np(want.mask))
    np.testing.assert_allclose(_np(got.ts), _np(want.ts), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(got.dts), _np(want.dts), rtol=0,
                               atol=1e-6)
    _, o, d, _, _ = _scene(0)
    p_t, d_t = tm.sample_points(_t(o), _t(d), got, 1.0)
    p_j, d_j = jm.sample_points(jnp.asarray(o), jnp.asarray(d), want, 1.0)
    np.testing.assert_allclose(_np(p_t), _np(p_j), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(d_t), _np(d_j))


def test_march_needs_jitter_and_constant_step():
    occ, o, d, nears, fars = _scene(1, n=4)
    with pytest.raises(ValueError, match="jitter"):
        tm.march_rays(_t(o), _t(d), _t(occ), _t(nears), _t(fars),
                      perturb=True, **MARCH)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.march_rays(_t(o), _t(d), _t(occ), _t(nears), _t(fars),
                      **dict(MARCH, dt_gamma=1 / 128))


def _samples(seed, N=48, K=24, C=3):
    rng = np.random.default_rng(seed)
    sig = rng.gamma(0.7, 8.0, (N, K)).astype(np.float32)
    vals = rng.uniform(size=(N, K, C)).astype(np.float32)
    dts = rng.uniform(0.005, 0.03, (N, K)).astype(np.float32)
    ts = np.cumsum(dts, -1).astype(np.float32) + 0.5
    mask = rng.uniform(size=(N, K)) < 0.7
    return sig, vals, dts, ts, mask


def test_composite_rays_matches():
    sig, vals, dts, ts, mask = _samples(2)
    want = jc.composite_rays(*(jnp.asarray(a) for a in
                               (sig, vals, dts, ts, mask)))
    got = tc.composite_rays(*(_t(a) for a in (sig, vals, dts, ts, mask)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    np.testing.assert_allclose(
        _np(tc.composite_with_background(got, _t(bg))),
        _np(jc.composite_with_background(want, jnp.asarray(bg))),
        rtol=0, atol=1e-6)


def test_flatten_samples_and_points_match():
    got_m, want_m = _march_both(3, perturb=True)
    budget = 64 * 12            # a fair share of 12 < 24: decimation
    want = jcp.flatten_samples(want_m, budget)
    got = tcp.flatten_samples(got_m, budget)
    for name in ("ray_id", "valid", "offsets"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(want, name)), name)
    assert _np(want.valid).mean() > 0.5
    for name in ("ts", "dts"):
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   _np(getattr(want, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    _, o, d, _, _ = _scene(3)
    for a, b in zip(tcp.flat_points(_t(o), _t(d), got, 1.0),
                    jcp.flat_points(jnp.asarray(o), jnp.asarray(d), want,
                                    1.0)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)


def _pool(seed):
    got_m, want_m = _march_both(seed, perturb=False)
    return (tcp.flatten_samples(got_m, 64 * 24),
            jcp.flatten_samples(want_m, 64 * 24))


def test_seg_sum_and_seg_broadcast_match_with_backward():
    got_f, want_f = _pool(4)
    rng = np.random.default_rng(4)
    M = got_f.ts.shape[0]
    x = rng.normal(size=(M, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tcp.seg_sum(_t(x), got_f.offsets)),
        _np(jcp.seg_sum(jnp.asarray(x), want_f.offsets)), rtol=0,
        atol=2e-5)
    v = rng.normal(size=(64, 2)).astype(np.float32)
    g = rng.normal(size=(M, 2)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a: jcp.seg_broadcast(a, want_f.ray_id,
                                                     want_f.offsets),
                         jnp.asarray(v))
    vt = _t(v).requires_grad_(True)
    out_t = tcp.seg_broadcast(vt, got_f.ray_id, got_f.offsets)
    np.testing.assert_array_equal(_np(out_t), _np(out_j))
    out_t.backward(_t(g))
    np.testing.assert_allclose(_np(vt.grad), _np(vjp(jnp.asarray(g))[0]),
                               rtol=0, atol=2e-5)


def test_composite_flat_matches():
    got_f, want_f = _pool(5)
    rng = np.random.default_rng(5)
    M = got_f.ts.shape[0]
    sig = rng.gamma(0.7, 8.0, M).astype(np.float32)
    vals = rng.uniform(size=(M, 3)).astype(np.float32)
    want = jcp.composite_flat(jnp.asarray(sig), jnp.asarray(vals), want_f,
                              64)
    got = tcp.composite_flat(_t(sig), _t(vals), got_f)
    assert float(_np(want.weights_sum).max()) > 0.5
    for name in ("image", "depth", "weights_sum", "weights"):
        np.testing.assert_allclose(_np(getattr(got, name)),
                                   _np(getattr(want, name)), rtol=2e-5,
                                   atol=2e-5, err_msg=name)
