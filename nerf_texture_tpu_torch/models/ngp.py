"""Instant-NGP NeRF model (port of ``nerf_texture_tpu/models/ngp.py``).

  sigma:  encode(x) -> MLP(2 x 64, no bias) -> (sigma=trunc_exp(h0),
          geo_feat=h[1:16])
  color:  [sh_encode(d), geo_feat] -> MLP(3 x 64, no bias) -> sigmoid rgb
  bg:     [sh_encode(d), hash2d(polar)] -> MLP(2 x 64) -> sigmoid rgb
          (only when bg_radius > 0, network.py:71-92)

The encoder is the packed one (``encoder='packed'``, one row gather a
level) or the per-corner Instant-NGP grid (``encoder='hash'``).
Parameters are the JAX pytree as tensors: ``{"grid": [rows, 128] packed
or [table_size, level_dim] per corner, "sigma_net": [{"w": [in, out]},
...], "color_net": [...]}``, and with a background sphere ``"bg_grid"``
[table_size, level_dim] and ``"bg_net"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.activation import trunc_exp
from ..ops.encoding import sh_encode, sh_encode_dim
from ..ops.hashgrid import HashGridSpec, hash_encode, hash_encode_bound
from ..ops.hashgrid_packed import PackedGridSpec, packed_encode_bound
from ..utils.mlp import apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    bound: float = 1.0
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: int = 2048  # scaled by bound like network.py:31
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    sh_degree: int = 4
    bg_radius: float = -1.0
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    align_corners: bool = True
    # "packed" = bricked one-gather-per-level encoder; "hash" = the
    # per-corner Instant-NGP layout
    encoder: str = "packed"
    log2_bricks: int = 16
    # inference reads hash-table rows through a bf16 copy
    infer_table_bf16: bool = True
    # an f32 table is read through bf16 rows, its gradient accumulated in
    # f32 (``hashgrid_packed._rows_lookup_amp``)
    train_table_bf16: bool = True

    @property
    def grid_spec(self) -> HashGridSpec:
        return HashGridSpec(
            input_dim=3, num_levels=self.num_levels,
            level_dim=self.level_dim,
            base_resolution=self.base_resolution,
            log2_hashmap_size=self.log2_hashmap_size,
            desired_resolution=int(self.desired_resolution * self.bound),
            align_corners=self.align_corners)

    @property
    def packed_spec(self) -> PackedGridSpec:
        return PackedGridSpec(
            input_dim=3, num_levels=self.num_levels,
            level_dim=self.level_dim,
            base_resolution=self.base_resolution,
            log2_bricks=self.log2_bricks,
            desired_resolution=int(self.desired_resolution * self.bound),
            align_corners=self.align_corners)

    @property
    def bg_grid_spec(self) -> HashGridSpec:
        # a much smaller 2D grid (network.py:74)
        return HashGridSpec(
            input_dim=2, num_levels=4, level_dim=self.level_dim,
            base_resolution=16, log2_hashmap_size=19,
            desired_resolution=2048, align_corners=self.align_corners)


def init(generator: torch.Generator, cfg: NGPConfig) -> dict[str, Any]:
    """Seeded parameters on the generator's device (the JAX init's
    distributions; torch draws other numbers from the same seed)."""
    spec = cfg.packed_spec if cfg.encoder == "packed" else cfg.grid_spec
    sigma_dims = ([spec.output_dim]
                  + [cfg.hidden_dim] * (cfg.num_layers - 1)
                  + [1 + cfg.geo_feat_dim])
    color_in = sh_encode_dim(cfg.sh_degree) + cfg.geo_feat_dim
    color_dims = ([color_in] + [cfg.hidden_dim_color]
                  * (cfg.num_layers_color - 1) + [3])
    params = {
        "grid": spec.init(generator),
        "sigma_net": init_mlp(generator, sigma_dims),
        "color_net": init_mlp(generator, color_dims),
    }
    if cfg.bg_radius > 0:
        bg_spec = cfg.bg_grid_spec
        bg_dims = ([bg_spec.output_dim + sh_encode_dim(cfg.sh_degree)]
                   + [cfg.hidden_dim_bg] * (cfg.num_layers_bg - 1) + [3])
        params["bg_grid"] = bg_spec.init(generator)
        params["bg_net"] = init_mlp(generator, bg_dims)
    return params


def encode_position(params, x: torch.Tensor, cfg: NGPConfig,
                    table_dtype=None) -> torch.Tensor:
    """Positional features for x in [-bound, bound].  Packed: table_dtype
    =bf16 reads the table through a bf16 copy (made here unless
    params["grid"] already is one, see ``hashgrid_packed.inference_table``);
    otherwise an f32 table is read through the AMP lookup when
    ``cfg.train_table_bf16`` is set, as in the JAX package.  Per corner
    (``encoder='hash'``): the f32 table, whatever table_dtype says."""
    if cfg.encoder != "packed":
        return hash_encode_bound(x, params["grid"], cfg.grid_spec,
                                 bound=cfg.bound)
    table = params["grid"]
    if table_dtype is not None and table.dtype != table_dtype:
        table = table.to(table_dtype)
        amp = False
    else:
        amp = cfg.train_table_bf16
    return packed_encode_bound(x, table, cfg.packed_spec, bound=cfg.bound,
                               amp=amp)


def density(params, x: torch.Tensor, cfg: NGPConfig, table_dtype=None):
    """x [..., 3] in [-bound, bound] -> (sigma [...], geo_feat [..., G])."""
    feat = encode_position(params, x, cfg, table_dtype=table_dtype)
    h = apply_mlp(params["sigma_net"], feat)
    return trunc_exp(h[..., 0]), h[..., 1:]


def color(params, d: torch.Tensor, geo_feat: torch.Tensor,
          cfg: NGPConfig) -> torch.Tensor:
    """d [..., 3] unit dirs; geo_feat [..., G] -> rgb [..., 3]."""
    h = torch.cat([sh_encode(d, cfg.sh_degree), geo_feat], dim=-1)
    return apply_mlp(params["color_net"], h, final_activation=torch.sigmoid)


def forward(params, x: torch.Tensor, d: torch.Tensor, cfg: NGPConfig,
            table_dtype=None):
    sigma, geo_feat = density(params, x, cfg, table_dtype=table_dtype)
    return sigma, color(params, d, geo_feat, cfg)


def background(params, polar: torch.Tensor, d: torch.Tensor,
               cfg: NGPConfig) -> torch.Tensor:
    """The learned background sphere's colour: polar [..., 2] in [-1, 1]
    sphere coords (``ops.marching.polar_from_ray``), d [..., 3] unit dirs
    -> rgb [..., 3]."""
    feat = hash_encode((polar + 1.0) * 0.5, params["bg_grid"],
                       cfg.bg_grid_spec)
    h = torch.cat([sh_encode(d, cfg.sh_degree), feat], dim=-1)
    return apply_mlp(params["bg_net"], h, final_activation=torch.sigmoid)
