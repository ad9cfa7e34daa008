"""Kernels and tensor ops of the port (see the package docstring)."""

from .activation import trunc_exp
from .composite import (CompositeResult, composite_rays,
                        composite_with_background)
from .encoding import freq_encode, freq_encode_dim, sh_encode, sh_encode_dim
from .hashgrid import HashGridSpec, hash_encode, hash_encode_bound
from .marching import (MarchResult, march_rays, near_far_from_aabb,
                       polar_from_ray, sample_points)
from .morton import morton3d, morton3d_invert
from . import occupancy

__all__ = [
    "trunc_exp", "CompositeResult", "composite_rays",
    "composite_with_background", "freq_encode", "freq_encode_dim",
    "sh_encode", "sh_encode_dim", "HashGridSpec", "hash_encode",
    "hash_encode_bound", "MarchResult", "march_rays", "near_far_from_aabb",
    "polar_from_ray", "sample_points", "morton3d", "morton3d_invert",
    "occupancy",
]
