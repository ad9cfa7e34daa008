"""The random numbers the JAX package's training draws from its keys, as
the port's draw tuples.  The port draws from a ``torch.Generator``; the
tests that hold its training against JAX's (and
``scripts/shell_lockstep.py``) hand it these instead, recomputed from
the keys JAX's functions split, so that both packages train on the same
draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerf_texture_tpu.data.rays import sample_ray_indices as jax_sample
from nerf_texture_tpu_torch.ops import occupancy as tocc
from nerf_texture_tpu_torch.train import curved_trainer as tct
from nerf_texture_tpu_torch.train import trainer as tt


def as_tensor(a, dtype=None) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype)


def ngp_grid_draws(key, full: bool, grid_size: int, cascades: int = 1,
                   bound: float = 1.0) -> list:
    """The draws JAX's ``occupancy.update`` takes from ``key``, one
    ``GridDraws`` a cascade: the full refresh's jitter of every cell, or
    the partial one's cells, keys and jitter."""
    out = []
    n = grid_size ** 3 // 4
    for cas in range(cascades):
        half = min(2 ** cas, bound) / grid_size
        if full:
            k1, key = jax.random.split(key)
            out.append(tocc.GridDraws(noise=as_tensor(jax.random.uniform(
                k1, (grid_size ** 3, 3), minval=-half, maxval=half))))
            continue
        k1, k2, k3, key = jax.random.split(key, 4)
        out.append(tocc.GridDraws(
            noise=as_tensor(jax.random.uniform(k3, (2 * n, 3), minval=-half,
                                               maxval=half)),
            cells=as_tensor(jax.random.randint(k1, (n,), 0, grid_size ** 3),
                            torch.int64),
            keys=as_tensor(jax.random.uniform(k2, (grid_size ** 3,)))))
    return out


def ngp_batch(frame, key, H: int, W: int, num_rays: int) -> tt.Batch:
    """The draws JAX's NGP ``train_step`` takes from ``key``."""
    k_pix, k_perturb, k_bg = jax.random.split(key, 3)
    inds, _ = jax_sample(k_pix, H, W, num_rays)
    return tt.Batch(frame=torch.tensor(int(frame)),
                    inds=as_tensor(inds, torch.int64),
                    u=as_tensor(jax.random.uniform(k_perturb, (num_rays,),
                                                   jnp.float32)),
                    bg=as_tensor(jax.random.uniform(k_bg, (3,))))


def curved_batch(key, frame, tcfg, rcfg, H: int, W: int,
                 fcfg) -> tct.CurvedBatch:
    """The draws JAX's ``curved_train_step`` takes from ``key`` (pixels,
    march jitter, per-pixel background, feature noise, clustering
    level); ``rcfg`` is the port's render config, ``fcfg`` the field's."""
    k_pix, k_perturb, k_bg, k_noise, k_reg = jax.random.split(key, 5)
    n = tcfg.num_rays
    L = fcfg.num_levels
    inds, _ = jax_sample(k_pix, H, W, n)
    rows = tct.noise_rows(rcfg, n)
    return tct.CurvedBatch(
        frame=torch.tensor(int(frame)), inds=as_tensor(inds, torch.int64),
        u=as_tensor(jax.random.uniform(k_perturb, (n,), jnp.float32)),
        bg=as_tensor(jax.random.uniform(k_bg, (n, 3))),
        noise=as_tensor(jax.random.normal(k_noise,
                                          (rows, L * fcfg.level_dim))),
        level=int(jax.random.randint(k_reg, (), 0, L)))


def curved_grid_noise(key, n: int, grid_size: int,
                      chunk: int = 262144) -> np.ndarray:
    """The [n, 3] jitter JAX's sparse refresh (``update_host_sparse``)
    draws from ``key`` over ``n`` near cells, ``chunk`` cells a draw
    (262,144 with the anchor table, 65,536 without it)."""
    half = 1.0 / grid_size
    out = []
    for start in range(0, n, chunk):
        key, k = jax.random.split(key)
        out.append(np.array(jax.random.uniform(
            k, (chunk, 3), minval=-half, maxval=half))[:n - start])
    return np.concatenate(out)
