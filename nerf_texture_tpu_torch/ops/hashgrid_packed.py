"""Packed (bricked) multiresolution hash encoding.

Port of ``nerf_texture_tpu/ops/hashgrid_packed.py``: parameters are stored
per brick of 2**D cells, one table row holding the brick's 3**D corner
lattice x C channels, so a sample needs ONE row gather per level and the
trilinear stencil is picked out of the row by lattice weights.  The table
keeps the JAX layout ``[table_rows, storage_width]`` so that rows convert
one to one.

Hashing: the JAX code multiplies uint32 brick coords by primes up to
3,674,653,429 with wrap-around.  PyTorch has no usable uint32 multiply,
so ids are computed in int64 and masked to 32 bits after every multiply
and XOR, which gives the same bits.

Table lookups go through ``_rows_lookup`` / ``_rows_scatter``, a pair of
``autograd.Function``s each of which is the other's backward, so
gradients of any order stay on them (the JAX custom-VJP pair); with
``amp`` an f32 table is read through ``_rows_lookup_amp`` (bf16 rows, f32
scatter-accumulated gradient).  They are plain PyTorch gathers and
``index_add_`` scatters: no TPU kernel stands behind them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .hashgrid import _HASH_PRIMES, _U32, _mul_u32


@dataclasses.dataclass(frozen=True)
class PackedGridSpec:
    """Static configuration of a packed (bricked) multires hash grid."""

    input_dim: int = 3
    num_levels: int = 8
    level_dim: int = 4
    base_resolution: int = 16
    log2_bricks: int = 16          # max bricks per hash level
    per_level_scale: float = 2.0
    desired_resolution: int | None = None
    align_corners: bool = True

    def __post_init__(self):
        if self.desired_resolution is not None:
            scale = math.exp2(
                math.log2(self.desired_resolution / self.base_resolution)
                / max(self.num_levels - 1, 1))
            object.__setattr__(self, "per_level_scale", scale)

    @property
    def log2_scale(self) -> float:
        return math.log2(self.per_level_scale)

    @property
    def lattice(self) -> int:
        return 3 ** self.input_dim

    @property
    def row_width(self) -> int:
        return self.lattice * self.level_dim

    @property
    def storage_width(self) -> int:
        """Row width padded to 128 lanes (the JAX table layout)."""
        return int(math.ceil(self.row_width / 128) * 128)

    def level_scale(self, level: int) -> float:
        return (math.exp2(level * self.log2_scale)
                * self.base_resolution - 1.0)

    def level_resolution(self, level: int) -> int:
        return int(math.ceil(self.level_scale(level))) + 1

    def level_brick_side(self, level: int) -> int:
        """Bricks per axis if stored dense."""
        return (self.level_resolution(level) + 1) // 2 + 1

    def level_bricks(self, level: int) -> int:
        side = self.level_brick_side(level)
        n = min(2 ** self.log2_bricks, side ** self.input_dim)
        return int(math.ceil(n / 8) * 8)

    def level_is_dense(self, level: int) -> bool:
        side = self.level_brick_side(level)
        return side ** self.input_dim <= 2 ** self.log2_bricks

    @property
    def offsets(self) -> tuple[int, ...]:
        offs = [0]
        for lvl in range(self.num_levels):
            offs.append(offs[-1] + self.level_bricks(lvl))
        return tuple(offs)

    @property
    def table_rows(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def init(self, generator: torch.Generator,
             std: float = 1e-4) -> torch.Tensor:
        """U(-std, std) f32 table [table_rows, storage_width] on the
        generator's device."""
        u = torch.rand((self.table_rows, self.storage_width),
                       generator=generator, device=generator.device)
        return u * (2.0 * std) - std

    @property
    def dual_storage_width(self) -> int:
        """Lanes of a table that co-stores a second channel group per
        brick (feature mean + log-variance): group A in [0, row_width),
        group B in [row_width, 2 row_width), padded to 128 lanes."""
        return int(math.ceil(2 * self.row_width / 128) * 128)

    def init_dual(self, generator: torch.Generator, std_a: float = 1e-4,
                  std_b: float = 1e-5, mean_b: float = 0.0) -> torch.Tensor:
        """Dual table [table_rows, dual_storage_width] on the generator's
        device: group A U(-std_a, std_a), group B and the padding lanes
        mean_b + U(-std_b, std_b)."""
        rw, sw = self.row_width, self.dual_storage_width
        dev = generator.device
        a = torch.rand((self.table_rows, rw), generator=generator,
                       device=dev) * (2.0 * std_a) - std_a
        b = torch.rand((self.table_rows, sw - rw), generator=generator,
                       device=dev) * (2.0 * std_b) - std_b + mean_b
        return torch.cat([a, b], dim=-1)


# ---------------------------------------------------------------------------
# row lookup with a scatter backward
# ---------------------------------------------------------------------------

class _RowsLookupFn(torch.autograd.Function):
    """table[idx] whose backward is ``_rows_scatter`` of the cotangent."""

    @staticmethod
    def forward(ctx, table, idx, n_rows: int):
        ctx.save_for_backward(idx)
        ctx.n_rows = n_rows
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _RowsScatterFn.apply(g, idx, ctx.n_rows), None, None


class _RowsScatterFn(torch.autograd.Function):
    """Transpose of ``_rows_lookup``: rows of g [B, W] summed into a
    [n_rows, W] table by idx (one index_add_); its backward is
    ``_rows_lookup`` of the cotangent."""

    @staticmethod
    def forward(ctx, g, idx, n_rows: int):
        ctx.save_for_backward(idx)
        ctx.n_rows = n_rows
        return g.new_zeros((n_rows, g.shape[1])).index_add_(0, idx, g)

    @staticmethod
    def backward(ctx, gt):
        (idx,) = ctx.saved_tensors
        return _RowsLookupFn.apply(gt, idx, ctx.n_rows), None, None


class _RowsLookupAmpFn(torch.autograd.Function):
    """Mixed-precision lookup: rows gathered from a bf16 copy of the f32
    table, the cotangent cast to f32 and scatter-accumulated into the
    f32 table."""

    @staticmethod
    def forward(ctx, table, idx, n_rows: int):
        ctx.save_for_backward(idx)
        ctx.n_rows = n_rows
        return table.to(torch.bfloat16)[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return (_RowsScatterFn.apply(g.to(torch.float32), idx, ctx.n_rows),
                None, None)


_rows_lookup = _RowsLookupFn.apply
_rows_scatter = _RowsScatterFn.apply
_rows_lookup_amp = _RowsLookupAmpFn.apply


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def _brick_ids(spec: PackedGridSpec, level: int,
               brick: torch.Tensor) -> torch.Tensor:
    """Global table row (int64) for [B, D] integer brick coords of one
    level: dense index or spatial hash, modulo the level's brick count,
    plus the level's offset -- bit-identical to the uint32 JAX math."""
    D = spec.input_dim
    n = spec.level_bricks(level)
    b = brick.to(torch.int64) & _U32            # the uint32 cast
    idx = torch.zeros(brick.shape[:-1], dtype=torch.int64,
                      device=brick.device)
    if spec.level_is_dense(level):
        side = spec.level_brick_side(level)
        stride = 1
        for d in range(D):
            idx = (idx + _mul_u32(b[..., d], stride & _U32)) & _U32
            stride *= side
    else:
        for d in range(D):
            idx = idx ^ _mul_u32(b[..., d], _HASH_PRIMES[d])
    return idx % n + spec.offsets[level]


_LATTICE_CACHE: dict[int, np.ndarray] = {}


def _lattice_offsets(D: int) -> np.ndarray:
    """[3**D, D] offsets in {0,1,2}**D, last dim fastest (C-order)."""
    if D not in _LATTICE_CACHE:
        grids = np.meshgrid(*([np.arange(3)] * D), indexing="ij")
        _LATTICE_CACHE[D] = np.stack([g.ravel() for g in grids], -1)
    return _LATTICE_CACHE[D]


def _indices_weights(spec: PackedGridSpec, x: torch.Tensor):
    """Per-level brick rows and lattice weights for [B, D] points in
    [0, 1]: (idx [L*B] int64, w [L, B, 3**D] f32, oob [B, 1] bool)."""
    D = spec.input_dim
    lat = torch.as_tensor(_lattice_offsets(D), dtype=x.dtype,
                          device=x.device)                 # [3**D, D]
    oob = torch.any((x < 0.0) | (x > 1.0), dim=-1, keepdim=True)
    shift = 0.0 if spec.align_corners else 0.5
    all_idx, all_w = [], []
    for level in range(spec.num_levels):
        pos = x * spec.level_scale(level) + shift
        pos_floor = torch.floor(pos)
        frac = pos - pos_floor                             # [B, D]
        cell = pos_floor.to(torch.int32)
        brick = cell >> 1                                  # [B, D]
        local = (cell & 1).to(x.dtype)                     # 0. or 1.
        all_idx.append(_brick_ids(spec, level, brick))     # [B]
        # per-dim weight of lattice offset o: (o==l)(1-f) + (o==l+1)f
        l = local[:, None, :]                              # [B, 1, D]
        f = frac[:, None, :]
        wd = (torch.where(lat[None] == l, 1.0 - f, 0.0)
              + torch.where(lat[None] == l + 1.0, f, 0.0))  # [B, 3**D, D]
        # the product over D as multiplies, not torch.prod: the weights
        # hold zeros, and prod's backward then takes a cumprod path that
        # took ~92% of a curved training step's device time on an H100
        # (the -grad(sigma) target differentiates the weights in x)
        w = wd[..., 0]
        for d in range(1, D):
            w = w * wd[..., d]
        all_w.append(w)                                    # [B, 3**D]
    return torch.cat(all_idx), torch.stack(all_w), oob


def _encode_groups(inputs: torch.Tensor, table: torch.Tensor,
                   spec: PackedGridSpec, amp: bool, groups: int):
    """The encode of ``groups`` channel groups that share each brick row
    (group g in lanes [g row_width, (g + 1) row_width)): one row gather,
    the lattice-weighted sum per group; a list of [..., L * C] f32."""
    D = spec.input_dim
    C = spec.level_dim
    L = spec.num_levels
    prefix = inputs.shape[:-1]
    x = inputs.reshape(-1, D)
    B = x.shape[0]
    idx, w, oob = _indices_weights(spec, x)
    if amp and table.dtype == torch.float32:
        rows = _rows_lookup_amp(table, idx, spec.table_rows)
    else:
        rows = _rows_lookup(table, idx, spec.table_rows)
    rows = rows[:, :groups * spec.row_width].reshape(L * B, groups,
                                                      spec.lattice, C)
    w = w.reshape(L * B, 1, spec.lattice, 1)
    if rows.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).to(torch.float32)
    out = torch.sum(w * rows.to(torch.float32), dim=2)     # [L*B, g, C]
    out = out.reshape(L, B, groups, C).permute(2, 1, 0, 3)
    out = out.reshape(groups, B, spec.output_dim)          # level-major
    out = torch.where(oob[None], 0.0, out)
    return [o.reshape(*prefix, spec.output_dim) for o in out]


def packed_encode(inputs: torch.Tensor, table: torch.Tensor,
                  spec: PackedGridSpec, amp: bool = False) -> torch.Tensor:
    """Encode [..., D] points in [0, 1] -> [..., L * C] f32 features
    (level-major), zero outside the unit cube.

    ``table`` is the f32 storage table [rows, storage_width] or an
    inference table in bf16 (any width >= row_width, see
    ``inference_table``).  ``amp`` reads an f32 table through bf16 rows
    (``_rows_lookup_amp``).  Whenever the rows are bf16 the lattice
    weights are rounded to bf16 too and the products accumulate in f32,
    as the JAX bf16 einsum with preferred_element_type=f32 does."""
    return _encode_groups(inputs, table, spec, amp, 1)[0]


def packed_encode_dual(inputs: torch.Tensor, table: torch.Tensor,
                       spec: PackedGridSpec, amp: bool = False):
    """Encode through a dual table (``init_dual``): ONE row gather gives
    (group_a [..., L * C], group_b [..., L * C]) -- the feature mean and
    log-variance of the curved model's probabilistic features.  ``amp``
    as in ``packed_encode``."""
    a, b = _encode_groups(inputs, table, spec, amp, 2)
    return a, b


def packed_encode_bound_dual(inputs: torch.Tensor, table: torch.Tensor,
                             spec: PackedGridSpec, bound: float = 1.0,
                             amp: bool = False):
    """Dual-group encode of points given in [-bound, bound]."""
    return packed_encode_dual((inputs + bound) / (2.0 * bound), table, spec,
                              amp=amp)


def packed_encode_pair(inputs: torch.Tensor, table_a: torch.Tensor,
                       table_b: torch.Tensor, spec: PackedGridSpec):
    """Encode [..., D] points in [0, 1] through TWO same-spec f32 tables
    with ONE row gather (and one scatter in the backward): the indices and
    weights are shared, the tables stacked row-wise, and the second
    table's rows are the first's ids plus ``table_rows``.  Returns
    (features of a, features of b), each [..., L * C] f32."""
    D = spec.input_dim
    C = spec.level_dim
    L = spec.num_levels
    R = spec.table_rows
    prefix = inputs.shape[:-1]
    x = inputs.reshape(-1, D)
    B = x.shape[0]
    idx, w, oob = _indices_weights(spec, x)
    tab = torch.cat([table_a, table_b], dim=0)             # [2R, W]
    rows = _rows_lookup(tab, torch.cat([idx, idx + R]), 2 * R)
    rows = rows[:, :spec.row_width].reshape(2, L, B, spec.lattice, C)
    out = torch.sum(w[None, ..., None] * rows.to(torch.float32), dim=3)
    out = out.permute(0, 2, 1, 3).reshape(2, B, spec.output_dim)
    out = torch.where(oob[None], 0.0, out)
    shape = (*prefix, spec.output_dim)
    return out[0].reshape(shape), out[1].reshape(shape)


def packed_encode_bound_pair(inputs: torch.Tensor, table_a: torch.Tensor,
                             table_b: torch.Tensor, spec: PackedGridSpec,
                             bound: float = 1.0):
    """Two-table encode of points given in [-bound, bound]."""
    return packed_encode_pair((inputs + bound) / (2.0 * bound), table_a,
                              table_b, spec)


def packed_encode_bound(inputs: torch.Tensor, table: torch.Tensor,
                        spec: PackedGridSpec, bound: float = 1.0,
                        amp: bool = False) -> torch.Tensor:
    """Encode points given in [-bound, bound]."""
    return packed_encode((inputs + bound) / (2.0 * bound), table, spec,
                         amp=amp)


def inference_table(table: torch.Tensor,
                    spec: PackedGridSpec) -> torch.Tensor:
    """The bf16 [rows, row_width] copy of a storage table that inference
    gathers from: half the bytes of each row, and none of the padding
    lanes.  Made once per set of parameters, not once per chunk.  Of a
    dual table it keeps group A (the means), which is all that the
    noise-free encode reads."""
    return table[:, :spec.row_width].to(torch.bfloat16).contiguous()
