"""Per-corner multiresolution hash grid (port of
``nerf_texture_tpu/ops/hashgrid.py``).

The Instant-NGP layout: one table row per grid corner, so a sample
gathers 2**D rows per level and weights them trilinearly.  The NGP's
``encoder='hash'`` and its learned background sphere (a 2D grid) read
it; the packed encoder (``hashgrid_packed.py``) hashes with the same
primes.

Hashing: the JAX code adds and multiplies uint32 corner coordinates with
wrap-around (an out-of-range point's negative coordinates wrap too).
PyTorch has no usable uint32 multiply, so indices are computed in int64
and masked to 32 bits after every product, sum and XOR -- before the
``% hashmap_size``, where a negative int64 would pick another row -- which
gives the same bits.

Forward: per level the corner indices, one row gather and the weighted
sum; the trilinear weights are written as explicit products (autograd of
``torch.prod`` goes through a cumprod, whose backward is slow on the
card).  Backward: plain autograd, so the table gradient is the gather's
scatter-add (``index_add_``; its float atomics on CUDA sum in no fixed
order) and input gradients of any order (``-grad(sigma)`` normals, a
loss on them) work.  The JAX encode is XLA, not a Pallas kernel: this
is plain PyTorch.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# Primes of the Instant-NGP spatial hash (prime[0] = 1 keeps the first
# axis coherent in memory; gridencoder/src/gridencoder.cu:36-51).
_HASH_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
                2165219737)

_U32 = 0xFFFFFFFF


def _mul_u32(a: torch.Tensor, p: int) -> torch.Tensor:
    """(a * p) mod 2**32 for int64 a in [0, 2**32) and p < 2**32, split
    into 16-bit halves of p so that no int64 product overflows."""
    lo = a * (p & 0xFFFF)
    hi = ((a * (p >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static configuration of a multiresolution hash grid: per-level
    resolution ``ceil(base * scale**level)``, per-level table size
    ``min(2**log2_hashmap_size, (res [+1])**D)`` rounded up to a multiple
    of 8, concatenated into one table."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    desired_resolution: int | None = None
    gridtype: str = "hash"  # "hash" | "tiled"
    align_corners: bool = False

    def __post_init__(self):
        if self.desired_resolution is not None:
            scale = math.exp2(
                math.log2(self.desired_resolution / self.base_resolution)
                / max(self.num_levels - 1, 1))
            object.__setattr__(self, "per_level_scale", scale)

    @property
    def log2_scale(self) -> float:
        return math.log2(self.per_level_scale)

    def level_params(self, level: int) -> int:
        res = int(math.ceil(
            self.base_resolution * self.per_level_scale ** level))
        side = res if self.align_corners else res + 1
        n = min(2 ** self.log2_hashmap_size, side ** self.input_dim)
        return int(math.ceil(n / 8) * 8)

    @property
    def offsets(self) -> tuple[int, ...]:
        offs = [0]
        for lvl in range(self.num_levels):
            offs.append(offs[-1] + self.level_params(lvl))
        return tuple(offs)

    @property
    def table_size(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def level_scale(self, level: int) -> float:
        # exp2f(level * S) * H - 1 (gridencoder/src/gridencoder.cu:126)
        return math.exp2(level * self.log2_scale) * self.base_resolution - 1.0

    def level_resolution(self, level: int) -> int:
        return int(math.ceil(self.level_scale(level))) + 1

    def init(self, generator: torch.Generator,
             std: float = 1e-4) -> torch.Tensor:
        """U(-std, std) f32 table [table_size, level_dim] on the
        generator's device."""
        u = torch.rand((self.table_size, self.level_dim),
                       generator=generator, device=generator.device)
        return u * (2.0 * std) - std


def _level_corner_indices(spec: HashGridSpec, level: int,
                          pos_grid: torch.Tensor) -> torch.Tensor:
    """Table row of each corner of one level: pos_grid [..., 2**D, D]
    integer corner coordinates -> int64 [...] rows of the global table,
    bit-identical to the JAX function's uint32 arithmetic."""
    D = spec.input_dim
    hashmap_size = spec.level_params(level)
    res = spec.level_resolution(level)
    side = res if spec.align_corners else res + 1
    p = pos_grid.to(torch.int64) & _U32            # the uint32 cast

    # dense (tiled) indexing while the stride still fits in the table
    # (gridencoder/src/gridencoder.cu:55-72)
    stride = 1
    index = torch.zeros(p.shape[:-1], dtype=torch.int64, device=p.device)
    for d in range(D):
        if stride > hashmap_size:
            break
        index = (index + _mul_u32(p[..., d], stride)) & _U32
        stride *= side

    if spec.gridtype == "hash" and stride > hashmap_size:
        index = torch.zeros_like(index)
        for d in range(D):
            index = index ^ _mul_u32(p[..., d], _HASH_PRIMES[d])

    return index % hashmap_size + spec.offsets[level]


def _corner_offsets(D: int) -> np.ndarray:
    """[2**D, D] binary corner offsets."""
    idx = np.arange(2 ** D, dtype=np.int32)
    return np.stack([(idx >> d) & 1 for d in range(D)], axis=-1)


def hash_encode(inputs: torch.Tensor, embeddings: torch.Tensor,
                spec: HashGridSpec) -> torch.Tensor:
    """Encode points with a multiresolution hash grid.

    inputs [..., D] in [0, 1] (a point outside encodes to zeros,
    gridencoder.cu:98-123); embeddings [table_size, C], f32.  Returns
    [..., L * C] f32 features, level-major (level 0's C channels
    first)."""
    D = spec.input_dim
    prefix = inputs.shape[:-1]
    x = inputs.reshape(-1, D)
    B = x.shape[0]
    oob = torch.any((x < 0.0) | (x > 1.0), dim=-1, keepdim=True)
    corners = torch.as_tensor(_corner_offsets(D), device=x.device)
    upper = corners.to(torch.bool)[None]                  # [1, 2**D, D]
    shift = 0.0 if spec.align_corners else 0.5

    # one level's [B, 2**D, C] gather at a time, reduced at once
    outs = []
    for level in range(spec.num_levels):
        scale = spec.level_scale(level)
        if shift:
            # XLA contracts x * scale + shift into one fused multiply-add:
            # the product and sum in f64, rounded once, are that number
            # (f32 * f32 is exact in f64)
            pos = (x.to(torch.float64) * float(np.float32(scale))
                   + shift).to(x.dtype)
        else:
            pos = x * scale                               # [B, D]
        pos_floor = torch.floor(pos)
        frac = pos - pos_floor
        corner_pos = (pos_floor.to(torch.int32)[:, None, :]
                      + corners[None])                    # [B, 2**D, D]
        idx = _level_corner_indices(spec, level, corner_pos)
        f = frac[:, None, :]
        wd = torch.where(upper, f, 1.0 - f)               # [B, 2**D, D]
        w = wd[..., 0]
        for d in range(1, D):
            w = w * wd[..., d]                            # [B, 2**D]
        vals = torch.index_select(embeddings, 0, idx.reshape(-1)).reshape(
            B, 2 ** D, spec.level_dim)
        outs.append(torch.sum(w[..., None] * vals, dim=1))
    out = torch.cat(outs, dim=-1)                         # [B, L * C]
    out = torch.where(oob, torch.zeros_like(out), out)
    return out.reshape(*prefix, spec.output_dim)


def hash_encode_bound(inputs: torch.Tensor, embeddings: torch.Tensor,
                      spec: HashGridSpec, bound: float = 1.0) -> torch.Tensor:
    """Encode points given in [-bound, bound] (GridEncoder.forward,
    gridencoder/grid.py:139-155)."""
    return hash_encode((inputs + bound) / (2.0 * bound), embeddings, spec)
