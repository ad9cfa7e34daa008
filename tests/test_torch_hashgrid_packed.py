"""Packed hash-grid encode in the PyTorch port vs the JAX package.

Tolerances: brick row ids exactly (integer hashing, uint32 wrap-around
emulated in int64); the f32-table encode within 1e-6 (27-term lattice
sums in another order); the bf16-table encode within 1e-3 (both sides
round table and weights to bf16 and accumulate in f32, but a last-bit
difference in a weight can round to a neighbouring bf16 value).
Row lookups are exact; row scatters and table gradients within 1e-5
relative to their largest entry (duplicate rows sum in another order);
the AMP table gradient within 1e-2 of its largest entry (each row's
cotangent is rounded to bf16 on both sides, from f32 products that may
differ in the last bit).
"""

import jax
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


# ---------------------------------------------------------------------------
# row lookup / scatter (the encode's table backward)
# ---------------------------------------------------------------------------

R_ROWS, WIDTH = 40, 12


def _rows_case(seed, B=300):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(R_ROWS, WIDTH)).astype(np.float32)
    idx = rng.integers(0, R_ROWS, B).astype(np.int32)   # many duplicates
    g = rng.normal(size=(B, WIDTH)).astype(np.float32)
    h = rng.normal(size=(R_ROWS, WIDTH)).astype(np.float32)
    return table, idx, g, h


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1.0))


def test_rows_lookup_and_scatter_match_jax_to_second_order():
    table, idx, g, h = _rows_case(0)
    tj, ij = jnp.asarray(table), jnp.asarray(idx)
    it = torch.from_numpy(idx.astype(np.int64))

    def jl(t):
        return jhp._rows_lookup(t, ij, R_ROWS)

    rows_j, vjp_j = jax.vjp(jl, tj)
    tt = torch.from_numpy(table).requires_grad_(True)
    rows_t = thp._rows_lookup(tt, it, R_ROWS)
    np.testing.assert_array_equal(rows_t.detach().numpy(),
                                  np.asarray(rows_j))
    # first order: the lookup's backward is the scatter
    gt = torch.from_numpy(g).requires_grad_(True)
    (grad_t,) = torch.autograd.grad(rows_t, tt, gt, create_graph=True)
    grad_j = vjp_j(jnp.asarray(g))[0]
    _close(grad_t.detach().numpy(), grad_j, 1e-5)
    _close(thp._rows_scatter(torch.from_numpy(g), it, R_ROWS).numpy(),
           jhp._rows_scatter(jnp.asarray(g), ij, R_ROWS), 1e-5)
    # second order: the scatter's backward is the lookup
    (gg_t,) = torch.autograd.grad(grad_t, gt, torch.from_numpy(h))
    gg_j = jax.vjp(lambda c: vjp_j(c)[0], jnp.asarray(g))[1](
        jnp.asarray(h))[0]
    np.testing.assert_array_equal(gg_t.numpy(), np.asarray(gg_j))
    np.testing.assert_array_equal(gg_t.numpy(), h[idx])


def test_rows_pair_gradgradcheck_f64():
    table, idx, g, _ = _rows_case(1, B=30)
    it = torch.from_numpy(idx.astype(np.int64))
    t64 = torch.from_numpy(table).double().requires_grad_(True)
    g64 = torch.from_numpy(g).double().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda t: thp._rows_lookup(t, it, R_ROWS), (t64,))
    assert torch.autograd.gradgradcheck(
        lambda t: thp._rows_lookup(t, it, R_ROWS), (t64,))
    assert torch.autograd.gradgradcheck(
        lambda c: thp._rows_scatter(c, it, R_ROWS), (g64,))


def test_rows_lookup_amp_matches_jax():
    table, idx, g, _ = _rows_case(2)
    ij = jnp.asarray(idx)
    rows_j, vjp_j = jax.vjp(
        lambda t: jhp._rows_lookup_amp(t, ij, R_ROWS), jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    rows_t = thp._rows_lookup_amp(tt, torch.from_numpy(idx.astype(np.int64)),
                                  R_ROWS)
    assert rows_t.dtype == torch.bfloat16 and rows_j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(rows_t.detach().float().numpy(),
                                  np.asarray(rows_j, np.float32))
    g16 = torch.from_numpy(g).to(torch.bfloat16)
    rows_t.backward(g16)
    grad_j = vjp_j(jnp.asarray(g16.float().numpy()).astype(jnp.bfloat16))[0]
    assert tt.grad.dtype == torch.float32 and grad_j.dtype == jnp.float32
    _close(tt.grad.numpy(), grad_j, 1e-5)


@pytest.mark.parametrize("amp", [False, True])
def test_encode_table_gradient_matches(amp):
    t, j = _specs(**SPEC_KW)
    rng = np.random.default_rng(6)
    table = rng.uniform(-1.0, 1.0, (t.table_rows, t.storage_width)).astype(
        np.float32)
    x = _points(500, 7)
    c = rng.normal(size=(500, t.output_dim)).astype(np.float32)
    grad_j = jax.grad(lambda tab: jnp.sum(jhp.packed_encode_bound(
        jnp.asarray(x), tab, j, amp=amp) * jnp.asarray(c)))(
            jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    out = thp.packed_encode_bound(torch.from_numpy(x), tt, t, amp=amp)
    torch.sum(out * torch.from_numpy(c)).backward()
    grad_j = np.asarray(grad_j)
    assert np.abs(grad_j).max() > 0.1
    _close(tt.grad.numpy(), grad_j, 1e-2 if amp else 1e-5)
