"""Packed hash-grid encode in the PyTorch port vs the JAX package.

Tolerances: brick row ids exactly (integer hashing, uint32 wrap-around
emulated in int64); the f32-table encode within 1e-6 (27-term lattice
sums in another order); the bf16-table encode within 1e-3 (both sides
round table and weights to bf16 and accumulate in f32, but a last-bit
difference in a weight can round to a neighbouring bf16 value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.ops import hashgrid_packed as jhp
from nerf_texture_tpu_torch.ops import hashgrid_packed as thp

SPEC_KW = dict(num_levels=6, level_dim=2, log2_bricks=10,
               desired_resolution=512)


def _specs(**kw):
    return thp.PackedGridSpec(**kw), jhp.PackedGridSpec(**kw)


def test_spec_layout_matches():
    for kw in (SPEC_KW, dict(num_levels=8, level_dim=4, log2_bricks=16,
                             desired_resolution=2048)):
        t, j = _specs(**kw)
        assert t.offsets == j.offsets
        assert (t.table_rows, t.storage_width, t.row_width, t.output_dim) \
            == (j.table_rows, j.storage_width, j.row_width, j.output_dim)
        for lvl in range(t.num_levels):
            assert t.level_is_dense(lvl) == j.level_is_dense(lvl)
            assert t.level_scale(lvl) == j.level_scale(lvl)
    np.testing.assert_array_equal(thp._lattice_offsets(3),
                                  jhp._lattice_offsets(3))


def test_brick_ids_match_exactly_dense_and_hashed():
    t, j = _specs(**SPEC_KW)
    dense = [l for l in range(t.num_levels) if t.level_is_dense(l)]
    hashed = [l for l in range(t.num_levels) if not t.level_is_dense(l)]
    assert dense and hashed
    rng = np.random.default_rng(0)
    for lvl in range(t.num_levels):
        side = t.level_brick_side(lvl)
        brick = rng.integers(0, side, (500, 3)).astype(np.int32)
        brick[:5] = [[-1, 0, 0], [0, -3, 2], [side, side, side],
                     [2 ** 20, 7, 2 ** 30], [-2 ** 31, 2 ** 31 - 1, 5]]
        got = thp._brick_ids(t, lvl, torch.from_numpy(brick)).numpy()
        want = np.asarray(jhp._brick_ids(j, lvl, jnp.asarray(brick)))
        np.testing.assert_array_equal(got, want)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    x[:8] *= 1.2                                  # some out of the cube
    return x


def test_row_ids_of_points_match():
    t, j = _specs(**SPEC_KW)
    x = (_points(400, 1) + 1.0) / 2.0
    idx_t, w_t, oob_t = thp._indices_weights(t, torch.from_numpy(x))
    idx_j, w_j, oob_j = jhp._indices_weights(j, jnp.asarray(x), jnp.float32)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(oob_t.numpy(), np.asarray(oob_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-6)


def test_encode_f32_table_matches():
    t, j = _specs(**SPEC_KW)
    table = np.random.default_rng(2).uniform(
        -1.0, 1.0, (t.table_rows, t.storage_width)).astype(np.float32)
    x = _points(600, 3)
    got = thp.packed_encode_bound(torch.from_numpy(x),
                                  torch.from_numpy(table), t).numpy()
    want = np.asarray(jhp.packed_encode_bound(
        jnp.asarray(x), jnp.asarray(table), j, fast=False))
    assert np.all(got[:8][np.any(np.abs(x[:8]) > 1, -1)] == 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_encode_bf16_table_matches():
    t, j = _specs(**SPEC_KW)
    table = np.random.default_rng(4).uniform(
        -1.0, 1.0, (t.table_rows, t.storage_width)).astype(np.float32)
    x = _points(600, 5)
    tab_t = thp.inference_table(torch.from_numpy(table), t)
    assert tab_t.dtype == torch.bfloat16 and tab_t.shape[1] == t.row_width
    got = thp.packed_encode_bound(torch.from_numpy(x), tab_t, t).numpy()
    want = np.asarray(jhp.packed_encode_bound(
        jnp.asarray(x), jnp.asarray(table).astype(jnp.bfloat16), j))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("std", [1e-4, 0.5])
def test_init_distribution(std):
    t, _ = _specs(**SPEC_KW)
    tab = t.init(torch.Generator().manual_seed(0), std=std)
    assert tab.shape == (t.table_rows, t.storage_width)
    assert tab.dtype == torch.float32
    assert float(tab.min()) >= -std and float(tab.max()) <= std
    assert abs(float(tab.mean())) < 0.01 * std
    assert abs(float(tab.std()) - std / np.sqrt(3.0)) < 0.01 * std
