"""Occupancy / density grid state (port of the container half of
``nerf_texture_tpu/ops/occupancy.py``).

The grid is C-order ``[cascade, H, H, H]`` flattened, as in the JAX
package, so a converted grid maps cell for cell.  The EMA ``update`` and
``mark_untrained`` belong to the training port."""

from __future__ import annotations

from typing import NamedTuple

import torch


class OccupancyGrid(NamedTuple):
    """Density-grid state; all fields are tensors on one device."""

    density: torch.Tensor       # [cascade, H**3] f32; -1 marks untrained
    occ: torch.Tensor           # [cascade * H**3] uint8 0/1 occupancy
    mean_density: torch.Tensor  # [] f32
    iter_density: torch.Tensor  # [] int32

    @property
    def cascades(self) -> int:
        return self.density.shape[0]


def create(grid_size: int = 128, cascades: int = 1,
           device: torch.device | str = "cpu") -> OccupancyGrid:
    return OccupancyGrid(
        density=torch.zeros((cascades, grid_size ** 3), dtype=torch.float32,
                            device=device),
        occ=torch.zeros((cascades * grid_size ** 3,), dtype=torch.uint8,
                        device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        iter_density=torch.zeros((), dtype=torch.int32, device=device),
    )
