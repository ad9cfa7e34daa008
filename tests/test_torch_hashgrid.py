"""The per-corner hash grid of the PyTorch port vs the JAX package's
``ops/hashgrid.py``, on the same numpy inputs.

Tolerances, each with its reason:
- ``HashGridSpec`` sizes and offsets, and the corner rows (2D and 3D,
  hash and tiled, corners in range and out of it): exact -- the same
  integer arithmetic (uint32 in JAX, int64 masked to 32 bits here);
- ``hash_encode`` / ``hash_encode_bound``: 1e-6 -- the same f32 products,
  the 2**D-term sums in another order;
- input and table gradients against ``jax.vjp``: 1e-5 of each one's
  largest entry -- the table gradient is a scatter-add whose float sums
  run in another order (and in no fixed order under CUDA atomics);
- the double backward (a loss on the input gradient, as -grad(sigma)
  normals need): finite, and within 1e-4 of JAX's relative to its max
  (products of two sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.ops import hashgrid as jhg
from nerf_texture_tpu_torch.ops import hashgrid as thg

SPECS = {
    "hash3d": dict(input_dim=3, num_levels=4, level_dim=2,
                   base_resolution=4, log2_hashmap_size=7,
                   per_level_scale=2.0),
    "hash3d_aligned": dict(input_dim=3, num_levels=5, level_dim=2,
                           base_resolution=16, log2_hashmap_size=12,
                           desired_resolution=256, align_corners=True),
    "tiled2d": dict(input_dim=2, num_levels=3, level_dim=2,
                    base_resolution=4, log2_hashmap_size=7,
                    per_level_scale=2.0, gridtype="tiled",
                    align_corners=True),
    "hash2d_bg": dict(input_dim=2, num_levels=4, level_dim=2,
                      base_resolution=16, log2_hashmap_size=19,
                      desired_resolution=2048, align_corners=True),
}


def _specs(name):
    return jhg.HashGridSpec(**SPECS[name]), thg.HashGridSpec(**SPECS[name])


def _points(n, D, seed, oob=True):
    x = np.random.default_rng(seed).uniform(0, 1, (n, D)).astype(np.float32)
    if oob:
        x[:4] = [[-0.1] * D, [1.2] * D, [0.5] * (D - 1) + [-0.3],
                 [0.0] * D]
    return x


def _table(spec, seed):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, (spec.table_size, spec.level_dim)).astype(np.float32)


def test_spec_sizes_and_offsets_match():
    for name in SPECS:
        js, ts = _specs(name)
        assert ts.offsets == js.offsets and ts.table_size == js.table_size
        assert ts.output_dim == js.output_dim
        assert ts.per_level_scale == js.per_level_scale
        for lvl in range(js.num_levels):
            assert ts.level_params(lvl) == js.level_params(lvl)
            assert ts.level_scale(lvl) == js.level_scale(lvl)
            assert ts.level_resolution(lvl) == js.level_resolution(lvl)
    # the NGP's default grid (16 levels, 2**19 rows)
    js = jhg.HashGridSpec(desired_resolution=2048)
    ts = thg.HashGridSpec(desired_resolution=2048)
    assert ts.offsets == js.offsets and ts.level_params(15) == 2 ** 19
    t = ts.init(torch.Generator().manual_seed(0), std=1e-4)
    assert t.shape == (js.table_size, 2) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 4e-5


@pytest.mark.parametrize("name", list(SPECS))
def test_corner_indices_match(name):
    js, ts = _specs(name)
    D = js.input_dim
    rng = np.random.default_rng(1)
    for lvl in range(js.num_levels):
        res = js.level_resolution(lvl)
        # corners in range, at the far edge, and of out-of-range points
        # (negative and beyond the grid: their uint32 casts wrap)
        pos = rng.integers(-3 * res, 4 * res, (500, 2 ** D, D))
        pos[:50] = rng.integers(0, res + 1, (50, 2 ** D, D))
        pos[50:60] = np.int32(-2 ** 31 + 7)
        pos = pos.astype(np.int32)
        want = np.asarray(jhg._level_corner_indices(js, lvl,
                                                    jnp.asarray(pos)))
        got = thg._level_corner_indices(ts, lvl, torch.from_numpy(pos))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want >= js.offsets[lvl]).all()
        assert (want < js.offsets[lvl + 1]).all()


@pytest.mark.parametrize("name", list(SPECS))
def test_hash_encode_matches(name):
    js, ts = _specs(name)
    x = _points(700, js.input_dim, 2)
    emb = _table(js, 3)
    want = np.asarray(jhg.hash_encode(jnp.asarray(x), jnp.asarray(emb), js))
    got = thg.hash_encode(torch.from_numpy(x), torch.from_numpy(emb), ts)
    assert got.shape == want.shape == (700, js.output_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (want[:3] == 0).all() and np.abs(want[3]).max() > 0  # out/in
    # leading dims kept; bound form
    xb = (x[:600] * 4.0 - 2.0).reshape(20, 30, js.input_dim)
    want = np.asarray(jhg.hash_encode_bound(jnp.asarray(xb),
                                            jnp.asarray(emb), js, bound=2.0))
    got = thg.hash_encode_bound(torch.from_numpy(xb), torch.from_numpy(emb),
                                ts, bound=2.0)
    assert got.shape == (20, 30, js.output_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["hash3d", "tiled2d", "hash2d_bg"])
def test_input_and_table_gradients_match_jax_vjp(name):
    js, ts = _specs(name)
    x = _points(400, js.input_dim, 4)
    emb = _table(js, 5)
    cot = np.random.default_rng(6).normal(
        size=(400, js.output_dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, e: jhg.hash_encode(a, e, js),
                     jnp.asarray(x), jnp.asarray(emb))
    gx_j, ge_j = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    xt = torch.from_numpy(x).requires_grad_(True)
    et = torch.from_numpy(emb).requires_grad_(True)
    thg.hash_encode(xt, et, ts).backward(torch.from_numpy(cot))
    for got, want in ((xt.grad, gx_j), (et.grad, ge_j)):
        assert float(np.abs(want).max()) > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    assert (gx_j[:3] == 0).all()            # out-of-range points


def test_double_backward_runs_and_matches():
    js, ts = _specs("hash3d")
    emb = _table(js, 7)
    x = _points(64, 3, 8, oob=False)

    def normal_loss_j(a):
        n = jax.grad(lambda b: jnp.sum(jhg.hash_encode(b, jnp.asarray(emb),
                                                       js) ** 2))(a)
        return jnp.sum(n ** 2)

    want = np.asarray(jax.grad(normal_loss_j)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    et = torch.from_numpy(emb).requires_grad_(True)
    s = torch.sum(thg.hash_encode(xt, et, ts) ** 2)
    (n,) = torch.autograd.grad(s, xt, create_graph=True)
    gx, ge = torch.autograd.grad(torch.sum(n ** 2), (xt, et))
    assert torch.isfinite(gx).all() and torch.isfinite(ge).all()
    assert float(ge.abs().max()) > 0       # the table's second-order term
    np.testing.assert_allclose(gx.numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
