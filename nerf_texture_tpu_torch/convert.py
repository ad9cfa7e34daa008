"""Convert JAX states, given as numpy arrays, into the port's tensors.

The layouts stay as they are at this boundary, so rows and cells map one
to one: the packed hash table is ``[table_rows, storage_width]`` (the
curved model's dual table ``[table_rows, dual_storage_width]``), MLP
weights are ``[in, out]``, the occupancy grid is C-order
``[cascade, H**3]``, the anchor table ``[H, H, H, 16]``.  The curved
param tree (``field.encoder``, ``field.clusters``,
``field.normal.{phi_grid, phi_net, theta_net}``, ``sigma_net`` and the
light model's leaves: SH ``light.{env_shs, brdf_net}``, SG
``light.{lgt_sgs, specular_reflectance, roughness, albedo_net[,
blend_net]}``, Envmap ``light.{env_map, brdf_net}``; with the vertex
encoder ``field.features_v`` [V, feature_dim] and ``field.clusters``
[1, 16, feature_dim] in place of the table) converts with
``params_from_jax`` as it is.  A JAX pytree is turned into numpy on the
JAX side (``jax.tree.map(np.asarray, params)``); nothing here imports
jax.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .ops.occupancy import OccupancyGrid


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def params_from_jax(tree: Any, device: torch.device | str = "cuda") -> Any:
    """Nested dicts / lists / tuples of arrays -> the same structure of
    tensors, e.g. an NGP ``{"grid": [R, 128], "sigma_net": [{"w": [in,
    out]}, ...], "color_net": [...]}`` (per corner ``"grid"`` is
    [table_size, level_dim]; with the background sphere also
    ``"bg_grid"`` and ``"bg_net"``)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return _tensor(tree, device)


def occupancy_from_jax(density, occ, mean_density, iter_density=0,
                       device: torch.device | str = "cuda") -> OccupancyGrid:
    """An ``OccupancyGrid`` from the JAX grid's fields."""
    return OccupancyGrid(
        density=_tensor(np.asarray(density, np.float32), device),
        occ=_tensor(np.asarray(occ, np.uint8), device),
        mean_density=_tensor(np.asarray(mean_density, np.float32), device),
        iter_density=_tensor(np.asarray(iter_density, np.int32), device))
