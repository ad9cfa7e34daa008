"""Factorised fine-normal network with Lipschitz-normalised MLPs (port of
``nerf_texture_tpu/models/normal_net.py``).

The fine normal is R(theta, phi) in the local TBN frame: phi (azimuth)
comes from its own hash grid over surface points plus the low z bands,
theta (polar tilt) from the low x / z feature bands.  The Lipschitz MLPs
run in f32, as the JAX ones (no bf16 operands); ``regularization`` is
their Lipschitz bound, a training regulariser.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..ops.hashgrid_packed import PackedGridSpec, packed_encode_bound
from ..utils.mlp import (copy_to_model, model_columns, reduce_from_model,
                         tp_layers)


def init_lip_mlp(generator: torch.Generator, in_dim: int, out_dim: int,
                 n_neurons: int = 16, num_layers: int = 2):
    """LipMLP params: num_layers hidden layers + a linear head; each layer
    {"w": 0.1 N(0, 1) [in, out], "b": 0 [out], "c": 1 []}."""
    dev = generator.device
    dims = [in_dim] + [n_neurons] * num_layers + [out_dim]
    return [{"w": 0.1 * torch.randn((dims[i], dims[i + 1]),
                                    generator=generator, device=dev),
             "b": torch.zeros((dims[i + 1],), device=dev),
             "c": torch.ones((), device=dev)}
            for i in range(len(dims) - 1)]


def apply_lip_mlp(layers, x: torch.Tensor) -> torch.Tensor:
    """Weights scaled column-wise by min(1, softplus(c) / sum|W_col|);
    ReLU between layers, linear head.  Layers split over a mesh's model
    axis run tensor-parallel (``utils.mlp``)."""
    if any(getattr(lyr["w"], "tp_split", None) is not None
           for lyr in layers):
        return tp_layers(layers, x, _lip_linear_tp)
    h = x
    n = len(layers)
    for i, lyr in enumerate(layers):
        absrowsum = torch.sum(torch.abs(lyr["w"]), dim=0)      # [out]
        scale = torch.clamp(F.softplus(lyr["c"]) / (absrowsum + 1e-12),
                            max=1.0)
        h = h @ (lyr["w"] * scale[None, :]) + lyr["b"]
        if i < n - 1:
            h = torch.relu(h)
    return h


def _lip_linear_tp(lyr, h, tp, mesh, last):
    """One Lipschitz layer of a split MLP.  A column layer scales its own
    columns (its c through ``copy_to_model``: its consumers are split);
    a row layer's column sums are partial, summed over the model group,
    and the scale they give reaches the split product through
    ``copy_to_model``."""
    w, c, b = lyr["w"], lyr["c"], lyr["b"]
    col = tp is not None and tp.dim == 1
    row = tp is not None and tp.dim == 0
    absrowsum = torch.sum(torch.abs(w), dim=0)
    if row:
        absrowsum = reduce_from_model(absrowsum, mesh)
    if col:
        c = copy_to_model(c, mesh)
        h = copy_to_model(h, mesh)
        b = model_columns(b, mesh, w.shape[1])
    scale = torch.clamp(F.softplus(c) / (absrowsum + 1e-12), max=1.0)
    if row:
        scale = copy_to_model(scale, mesh)
    h = h @ (w * scale[None, :])
    if row:
        h = reduce_from_model(h, mesh)
    h = h + b
    return h if last else torch.relu(h)


def lip_regularization(layers) -> torch.Tensor:
    """The product of softplus(c) over the layers: the Lipschitz bound of
    the MLP."""
    loss = 1.0
    for lyr in layers:
        loss = loss * F.softplus(lyr["c"])
    return loss


def regularization(params) -> torch.Tensor:
    """Lipschitz bounds of the phi and theta MLPs, summed."""
    return (lip_regularization(params["phi_net"])
            + lip_regularization(params["theta_net"]))


@dataclasses.dataclass(frozen=True)
class NormalNetConfig:
    """Every field of the JAX NormalNetConfig."""

    x_dim: int = 16                    # feature embedding width
    z_dim: int = 25                    # height embedding width
    theta_scale: float = math.pi / 2 * 1.1
    phi_scale: float = math.pi * 2 * 1.1
    bound_output: bool = False
    lip: bool = True
    low_freq_band_len_f: int = 32
    low_freq_band_len_z: int = 12
    n_neurons: int = 16
    num_layers: int = 2
    bound: float = 1.0

    @property
    def band_x(self) -> int:
        return min(self.x_dim, self.low_freq_band_len_f)

    @property
    def band_z(self) -> int:
        return min(self.z_dim, self.low_freq_band_len_z)

    @property
    def phi_grid_spec(self) -> PackedGridSpec:
        # 4 levels x 2 channels over surface points, 512 -> 1024
        return PackedGridSpec(input_dim=3, num_levels=4, level_dim=2,
                              base_resolution=512, desired_resolution=1024,
                              log2_bricks=16, align_corners=True)

    @property
    def phi_embed_dim(self) -> int:
        return self.phi_grid_spec.output_dim


def init(generator: torch.Generator, cfg: NormalNetConfig) -> dict[str, Any]:
    """{"phi_grid": U(0, 1e-3) packed table, "phi_net", "theta_net"}."""
    spec = cfg.phi_grid_spec
    grid = torch.rand((spec.table_rows, spec.storage_width),
                      generator=generator, device=generator.device) * 1e-3
    return {
        "phi_grid": grid,
        "phi_net": init_lip_mlp(generator, cfg.phi_embed_dim + cfg.band_z, 1,
                                cfg.n_neurons, cfg.num_layers),
        "theta_net": init_lip_mlp(generator, cfg.band_x + cfg.band_z, 1,
                                  cfg.n_neurons, cfg.num_layers),
    }


def phi_embedding(params, p_sur: torch.Tensor, cfg: NormalNetConfig,
                  amp: bool = False) -> torch.Tensor:
    """The phi hash grid at surface points [N, 3]; ``amp`` reads an f32
    table through bf16 rows (a bf16 inference table is read as it is)."""
    return packed_encode_bound(p_sur, params["phi_grid"], cfg.phi_grid_spec,
                               bound=cfg.bound, amp=amp)


def to_coord(phi: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Spherical (phi, theta) [..., 1] -> unit vector, z-up local frame."""
    sin_t = torch.sin(theta)
    return torch.cat([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                      torch.cos(theta)], dim=-1)


def apply(params, z_embed: torch.Tensor, x_embed: torch.Tensor,
          cfg: NormalNetConfig, *, p_sur=None, phi_embed=None, tbn=None,
          return_rot_angles: bool = False):
    """The fine normal [N, 3] in the local frame (rotated by tbn [N, 3, 3]
    when given).  Exactly one of p_sur / phi_embed is given."""
    if phi_embed is None:
        phi_embed = phi_embedding(params, p_sur, cfg)
    z_low = z_embed[..., :cfg.band_z]
    geo = torch.cat([x_embed[..., :cfg.band_x], z_low], dim=-1)
    phi = apply_lip_mlp(params["phi_net"], torch.cat([phi_embed, z_low], -1))
    theta = apply_lip_mlp(params["theta_net"], geo)
    if cfg.bound_output:
        theta = cfg.theta_scale * torch.sigmoid(theta)
        phi = cfg.phi_scale * torch.sigmoid(phi)
    if return_rot_angles:
        return theta, phi
    normal = to_coord(phi, theta)
    if tbn is None:
        return normal
    return torch.einsum("na,nab->nb", normal, tbn)
