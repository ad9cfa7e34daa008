"""Morton codes and ``occupancy.packbits`` of the PyTorch port vs the JAX
package (``ops/morton.py``, ``ops/occupancy.py::packbits``), on random
coordinates below 1024 and random grids: exact -- the same integer and
comparison arithmetic (uint32 in JAX, int64 masked to 32 bits here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.ops import morton3d as jax_morton
from nerf_texture_tpu.ops import morton3d_invert as jax_invert
from nerf_texture_tpu.ops import occupancy as jocc
from nerf_texture_tpu_torch.ops import morton3d, morton3d_invert
from nerf_texture_tpu_torch.ops import occupancy as tocc


def test_morton3d_and_its_inverse_match():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 1024, (20000, 3)).astype(np.int32)
    c[:4] = [[0, 0, 0], [1023, 1023, 1023], [1, 0, 0], [0, 0, 1023]]
    want = np.asarray(jax_morton(jnp.asarray(c)))
    got = morton3d(torch.from_numpy(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = morton3d_invert(got)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), c)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_invert(jnp.asarray(want))))
    # codes of any 32 bits, the top bit set too
    codes = rng.integers(-2 ** 31, 2 ** 31, 20000).astype(np.int32)
    np.testing.assert_array_equal(
        morton3d_invert(torch.from_numpy(codes)).numpy(),
        np.asarray(jax_invert(jnp.asarray(codes))))


def test_morton3d_walks_a_whole_grid():
    """Every cell of a 32^3 grid: the codes are a permutation of the cell
    ids, in batched leading dims."""
    g = np.stack(np.meshgrid(*[np.arange(32)] * 3, indexing="ij"), -1)
    got = morton3d(torch.from_numpy(g.astype(np.int32)))
    assert got.shape == (32, 32, 32)
    assert sorted(got.reshape(-1).tolist()) == list(range(32 ** 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_morton(jnp.asarray(g.astype(np.int32)))))


@pytest.mark.parametrize("shape,thresh", [((1, 16 ** 3), 0.5),
                                          ((2, 8 ** 3), 0.01),
                                          ((4096,), -1.0)])
def test_packbits_matches(shape, thresh):
    grid = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    grid.reshape(-1)[:16] = thresh          # a cell at the threshold is off
    want = np.asarray(jocc.packbits(jnp.asarray(grid), thresh))
    got = tocc.packbits(torch.from_numpy(grid), thresh)
    assert got.dtype == torch.uint8 and got.shape == (grid.size // 8,)
    np.testing.assert_array_equal(got.numpy(), want)
    bits = np.unpackbits(got.numpy(), bitorder="little").astype(bool)
    np.testing.assert_array_equal(bits, grid.reshape(-1) > thresh)
