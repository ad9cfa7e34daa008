"""Coordinate encodings (port of ``nerf_texture_tpu/ops/encoding.py``):
the NeRF frequency encoding and the real spherical-harmonics basis."""

from __future__ import annotations

import math

import numpy as np
import torch


def freq_encode(x: torch.Tensor, n_freqs: int,
                max_freq_log2: float | None = None,
                include_input: bool = True,
                log_sampling: bool = True) -> torch.Tensor:
    """[x, sin(f0 x), cos(f0 x), sin(f1 x), ...] over the last axis, with
    bands 2**linspace(0, max_freq_log2, n_freqs) (log-spaced) or
    linspace(1, 2**max_freq_log2, n_freqs); [..., D] ->
    [..., D * (include_input + 2 n_freqs)]."""
    if max_freq_log2 is None:
        max_freq_log2 = n_freqs - 1
    if log_sampling:
        bands = [2.0 ** f for f in
                 (np.linspace(0.0, max_freq_log2, n_freqs).tolist()
                  if n_freqs > 1 else [0.0])]
    else:
        bands = np.linspace(2.0 ** 0.0, 2.0 ** max_freq_log2,
                            n_freqs).tolist()
    out = [x] if include_input else []
    for f in bands:
        xf = x * f
        out.append(torch.sin(xf))
        out.append(torch.cos(xf))
    return torch.cat(out, dim=-1)


def freq_encode_dim(input_dim: int, n_freqs: int,
                    include_input: bool = True) -> int:
    return input_dim * ((1 if include_input else 0) + 2 * n_freqs)


def _double_factorial(n: int) -> int:
    out = 1
    while n > 1:
        out *= n
        n -= 2
    return out


def _sh_basis_coeffs(degree: int) -> dict[tuple[int, int], float]:
    """Normalisation K_l^m of the real SH basis (sqrt(2) for m > 0)."""
    coeffs = {}
    for l in range(degree):
        for m in range(l + 1):
            k = math.sqrt((2 * l + 1) / (4.0 * math.pi)
                          * math.factorial(l - m) / math.factorial(l + m))
            if m > 0:
                k *= math.sqrt(2.0)
            coeffs[(l, m)] = k
    return coeffs


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real SH basis at unit directions [..., 3] -> [..., degree**2],
    channels ordered l*l + l + m (same recurrences as the JAX module)."""
    if not 1 <= degree <= 8:
        raise ValueError(f"sh degree must be in [1, 8], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    K = _sh_basis_coeffs(degree)

    # c_m = Re((x + i y)^m), s_m = Im((x + i y)^m)
    c = [torch.ones_like(x)]
    s = [torch.zeros_like(x)]
    for m in range(1, degree):
        c.append(x * c[m - 1] - y * s[m - 1])
        s.append(x * s[m - 1] + y * c[m - 1])

    # pbar[l][m] = P_l^m / sin^m(theta), polynomials in z
    pbar = [[None] * degree for _ in range(degree)]
    for m in range(degree):
        pmm = ((-1.0) ** m) * _double_factorial(2 * m - 1)
        pbar[m][m] = pmm * torch.ones_like(z)
        if m + 1 < degree:
            pbar[m + 1][m] = (2 * m + 1) * pmm * z
        for l in range(m + 2, degree):
            pbar[l][m] = ((2 * l - 1) * z * pbar[l - 1][m]
                          - (l + m - 1) * pbar[l - 2][m]) / (l - m)

    out = [None] * (degree * degree)
    for l in range(degree):
        out[l * l + l] = K[(l, 0)] * pbar[l][0]
        for m in range(1, l + 1):
            base = K[(l, m)] * pbar[l][m]
            out[l * l + l + m] = base * c[m]
            out[l * l + l - m] = base * s[m]
    return torch.stack(out, dim=-1)


def sh_encode_dim(degree: int) -> int:
    return degree * degree
