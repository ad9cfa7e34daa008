"""Explicit light-probe environment light (Blinn-Phong style; port of
``nerf_texture_tpu/models/lights/envmap.py``).

A learnable env_res x env_res grid of light probes with per-pixel solid
angles, a BRDF MLP head (albedo 3, specular 1, glossiness 1), diffuse
n.l and specular (n.h)^gloss terms with the coarse normal's hemisphere
visibility, and 1 / gamma tone mapping.  Every point is shaded against
every probe: [N, env_res^2, 3] temporaries.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.mlp import apply_mlp, init_mlp
from .sh import safe_pow


@dataclasses.dataclass(frozen=True)
class EnvmapLightConfig:
    """Every field of the JAX EnvmapLightConfig."""

    input_dim: int = 15
    env_res: int = 16
    white_light: bool = True
    use_specular: bool = True
    min_glossiness: float = 1.0
    gamma: float = 2.4
    hidden: int = 64
    num_layers: int = 3


def gen_light_dirs(h: int, w: int):
    """Probe directions [h, w, 3] and solid angles [h, w] on the latlong
    sphere (host numpy, f32)."""
    lat_step = math.pi / (h + 2)
    lng_step = 2 * math.pi / (w + 2)
    lats = np.linspace(math.pi / 2 - lat_step, -math.pi / 2 + lat_step, h)
    lngs = np.linspace(math.pi - lng_step, -math.pi + lng_step, w)
    lngs_g, lats_g = np.meshgrid(lngs, lats)
    x = np.cos(lats_g) * np.cos(lngs_g)
    y = np.cos(lats_g) * np.sin(lngs_g)
    z = np.sin(lats_g)
    dirs = np.stack([x, y, z], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    sin_colat = np.sin(math.pi / 2 - lats_g)
    areas = 4 * math.pi * sin_colat / np.sum(sin_colat)
    return dirs.astype(np.float32), areas.astype(np.float32)


def light_dirs(res: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``gen_light_dirs(res, res)`` flattened, (dirs [K, 3], areas
    [K, 1]), one copy per (res, device)."""
    return _light_dirs(res, torch.device(device))


@functools.lru_cache(maxsize=None)
def _light_dirs(res: int, device: torch.device):
    dirs, areas = gen_light_dirs(res, res)
    return (torch.as_tensor(dirs.reshape(-1, 3), device=device),
            torch.as_tensor(areas.reshape(-1, 1), device=device))


def init(generator: torch.Generator, cfg: EnvmapLightConfig) -> dict[str, Any]:
    """Seeded params on the generator's device: {"env_map" [res, res, 1
    or 3] normal x sqrt(2 / (res^2 + C)), "brdf_net"}."""
    cdim = 1 if cfg.white_light else 3
    fan = cfg.env_res * cfg.env_res
    env = torch.randn((cfg.env_res, cfg.env_res, cdim), generator=generator,
                      device=generator.device) * math.sqrt(2.0 / (fan + cdim))
    dims = [cfg.input_dim] + [cfg.hidden] * (cfg.num_layers - 1) + [5]
    return {"env_map": env, "brdf_net": init_mlp(generator, dims, bias=True)}


def apply(params, geo_feat, normals, view_dirs, cfg: EnvmapLightConfig, *,
          normal_coarse=None, gamma=None, env_import=None, **_):
    """Shade points: (full, specular, diffuse, albedo), each [N, 3].
    Probes behind the coarse normal's hemisphere are masked
    (``normal_coarse``); ``env_import`` [res, res, C] replaces the
    learned probe grid."""
    env = params["env_map"] if env_import is None else env_import
    l, area = light_dirs(cfg.env_res, geo_feat.device)        # [K, 3]
    brdf = apply_mlp(params["brdf_net"], geo_feat)
    k_d = torch.sigmoid(brdf[..., :3])
    k_s = torch.sigmoid(brdf[..., 3:4])
    gloss = F.softplus(brdf[..., 4:5]) + cfg.min_glossiness

    v = -view_dirs[:, None, :]                                # [N, 1, 3]
    h = l[None] + v
    h = h / (torch.linalg.norm(h, dim=-1, keepdim=True) + 1e-5)
    nl = torch.clamp(torch.sum(normals[:, None, :] * l[None], -1,
                               keepdim=True), 0.0, 1.1)
    nh = torch.clamp(torch.sum(normals[:, None, :] * h, -1, keepdim=True),
                     0.0, 1.1)
    if normal_coarse is not None:
        vis = (torch.sum(normal_coarse[:, None, :] * l[None], -1,
                         keepdim=True) > 0).to(nl.dtype)
    else:
        vis = torch.ones_like(nl)
    light = F.softplus(env).reshape(-1, env.shape[-1]) * area
    diffuse = torch.sum(k_d[:, None, :] * nl * light[None] * vis, dim=1)
    if cfg.use_specular:
        specular = torch.sum(k_s[:, None, :] * torch.pow(nh, gloss[:, None, :])
                             * light[None] * vis, dim=1)
        specular = specular.expand(diffuse.shape)
    else:
        specular = torch.zeros_like(diffuse)
    color = torch.clamp(diffuse + specular, min=0.0)
    g = cfg.gamma if gamma is None else gamma
    return (safe_pow(color, 1.0 / g),
            safe_pow(torch.clamp(specular, 0, 1), 1.0 / g),
            safe_pow(torch.clamp(diffuse, 0, 1), 1.0 / g),
            torch.clamp(k_d, 0.0, 1.0))
