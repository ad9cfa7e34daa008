"""Spherical-harmonics environment light + BRDF head (port of the learned
environment of ``nerf_texture_tpu/models/lights/sh.py``).

A learnable order-3 SH environment, a BRDF MLP (albedo 3, specular 1,
glossiness 1), cosine-lobe diffuse irradiance, glossiness-attenuated
specular at the reflection direction, and ``color ** (1 / gamma)`` tone
mapping.  All SH math goes through ``ops.encoding.sh_encode``.

Imported environments (``env_import``, the per-probe visibility products)
are not ported and raise ``NotImplementedError`` naming ROADMAP Queue 1,
item 11.1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.encoding import sh_encode
from ...utils.mlp import apply_mlp, init_mlp

# cosine-lobe coefficients / pi of the first three SH bands
_COSINE_LOBE = np.array([3.14, 2.09, 2.09, 2.09,
                         0.79, 0.79, 0.79, 0.79, 0.79], np.float32) / math.pi


@dataclasses.dataclass(frozen=True)
class SHLightConfig:
    """Every field of the JAX SHLightConfig."""

    input_dim: int = 15
    sh_order: int = 3           # (order+1)**2 coefficients
    white_light: bool = True
    use_specular: bool = True
    min_glossiness: float = 1.0
    gamma: float = 2.4
    hidden: int = 64
    num_layers: int = 3

    @property
    def n_coeffs(self) -> int:
        return (self.sh_order + 1) ** 2


def init(generator: torch.Generator, cfg: SHLightConfig) -> dict[str, Any]:
    """{"env_shs": [n_coeffs, 1 or 3] (3.0 in the DC term), "brdf_net"}."""
    color_dim = 1 if cfg.white_light else 3
    env = torch.zeros((cfg.n_coeffs, color_dim), device=generator.device)
    env[0] = 3.0
    dims = [cfg.input_dim] + [cfg.hidden] * (cfg.num_layers - 1) + [5]
    return {"env_shs": env, "brdf_net": init_mlp(generator, dims, bias=True)}


def safe_pow(x: torch.Tensor, p: float) -> torch.Tensor:
    return torch.pow(torch.clamp(x, min=1e-6), p)


def sh_eval_color(coeffs: torch.Tensor, dirs: torch.Tensor,
                  degree: int) -> torch.Tensor:
    """SH expansion with per-channel coeffs [..., n, C] at unit dirs
    [..., 3] -> [..., C]."""
    basis = sh_encode(dirs, degree)
    return torch.einsum("...n,...nc->...c", basis,
                        coeffs[..., :degree * degree, :])


def irradiance(coeffs9: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Diffuse irradiance: the cosine-lobe product of the first 9
    coefficients, evaluated at the normal."""
    lobe = torch.as_tensor(_COSINE_LOBE, device=coeffs9.device)
    return sh_eval_color(coeffs9[..., :9, :] * lobe[:, None], normal, 3)


def apply(params, geo_feat: torch.Tensor, normals_primary: torch.Tensor,
          view_dirs: torch.Tensor, cfg: SHLightConfig, *,
          normals_secondary=None, shade_visibility: bool = False,
          gamma=None, env_import=None, env_import_vis=None, probes=None):
    """Shade points: returns (full, specular, diffuse, albedo), each
    [N, 3], under the learned environment."""
    if env_import is not None or env_import_vis is not None \
            or probes is not None:
        raise NotImplementedError(
            "sh.apply: imported environments (env_import, visibility "
            "probes) are not ported; ROADMAP Queue 1, item 11.1")
    env = params["env_shs"].expand(geo_feat.shape[0],
                                   *params["env_shs"].shape)
    if env.shape[-1] == 1:
        env = env.expand(*env.shape[:-1], 3)

    brdf = apply_mlp(params["brdf_net"], geo_feat)
    albedo = torch.sigmoid(brdf[..., :3])
    spec_w = torch.sigmoid(brdf[..., 3:4])
    gloss = F.softplus(brdf[..., 4:5]) + cfg.min_glossiness

    diffuse_rgb = torch.clamp(irradiance(env[..., :9, :3], normals_primary),
                              min=0.0)
    diffuse = albedo * diffuse_rgb
    if cfg.use_specular:
        d = view_dirs / (torch.linalg.norm(view_dirs, dim=-1, keepdim=True)
                         + 1e-6)
        cos_t = -torch.sum(d * normals_primary, dim=-1, keepdim=True)
        refl = 2.0 * cos_t * normals_primary + d
        refl = refl / (torch.linalg.norm(refl, dim=-1, keepdim=True) + 1e-6)
        # band attenuation exp(-l^2 / (2 s))
        l_of = torch.floor(torch.sqrt(torch.arange(
            9, dtype=torch.float32, device=geo_feat.device)))
        atten = torch.exp(-(l_of ** 2)[None, :, None]
                          / (2.0 * gloss[..., None]))
        specular = spec_w * irradiance(atten * env[..., :9, :3], refl)
    else:
        specular = torch.zeros_like(diffuse)
    color = torch.clamp(diffuse + specular, min=0.0)
    g = cfg.gamma if gamma is None else gamma
    return (safe_pow(color, 1.0 / g),
            safe_pow(torch.clamp(specular, 0.0, 1.0), 1.0 / g),
            safe_pow(torch.clamp(diffuse, 0.0, 1.0), 1.0 / g),
            torch.clamp(albedo, 0.0, 1.0))
