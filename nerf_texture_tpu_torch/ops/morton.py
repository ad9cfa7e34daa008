"""Morton (Z-order) codes for 3D grid coordinates (port of
``nerf_texture_tpu/ops/morton.py``): ``__morton3D`` /
``__morton3D_invert`` of raymarching/src/raymarching.cu (:58-82,
:216-262) as uint32 bit arithmetic, here in int64 masked to 32 bits after
every product.  The density grids are stored in C order; the codes serve
tooling and tests."""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """Interleave the bits of [..., 3] integer coords (each < 1024) ->
    [...] int32 codes."""
    c = coords.to(torch.int64) & _U32
    xx = _expand_bits(c[..., 0])
    yy = _expand_bits(c[..., 1])
    zz = _expand_bits(c[..., 2])
    return ((xx | (yy << 1) | (zz << 2)) & _U32).to(torch.int32)


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(codes: torch.Tensor) -> torch.Tensor:
    """Invert ``morton3d``: [...] codes -> [..., 3] int32 coords."""
    ind = codes.to(torch.int64) & _U32
    return torch.stack([_compact_bits(ind), _compact_bits(ind >> 1),
                        _compact_bits(ind >> 2)], dim=-1).to(torch.int32)
