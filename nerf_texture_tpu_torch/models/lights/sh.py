"""Spherical-harmonics environment light + BRDF head (port of the learned
environment of ``nerf_texture_tpu/models/lights/sh.py``).

A learnable order-3 SH environment, a BRDF MLP (albedo 3, specular 1,
glossiness 1), cosine-lobe diffuse irradiance, glossiness-attenuated
specular at the reflection direction, and ``color ** (1 / gamma)`` tone
mapping.  All SH math goes through ``ops.encoding.sh_encode``.

Imported environments: an equirect image (``image_to_envmap``) projected
onto SH coefficients (``envmap_to_sh``), shaded as it is (``env_import``)
or, with visibility, per probe direction (``build_visibility_probes``:
the environment times a clamped-cosine visibility lobe turned to the
probe, ``fit_product_shs``); each point reads the probe nearest its
coarse normal.
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

# zonal coefficients of the clamped-cosine visibility lobe (m = 0 only)
_VIS_ZONAL = np.array([0.8754318, 1.023545, 0.449686], np.float32)


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


def zonal_rotate(zonal, normal: torch.Tensor) -> torch.Tensor:
    """The 9 SH coefficients [..., 9] of a zonal (m = 0) lobe with band
    coefficients ``zonal`` [3] turned to point along ``normal`` [..., 3]:
    z_l sqrt(4 pi / (2l + 1)) Y_lm(normal), exact for zonal functions."""
    scale = np.concatenate([
        np.full(2 * l + 1, math.sqrt(4 * math.pi / (2 * l + 1)) * zonal[l])
        for l in range(3)]).astype(np.float32)
    return sh_encode(normal, 3)[..., :9] * torch.as_tensor(
        scale, device=normal.device)


def fit_product_shs(coeffs_a9: torch.Tensor, coeffs_b9: torch.Tensor,
                    dirs: torch.Tensor | None = None, n_dirs: int = 4096):
    """SH coefficients [9, C] of the product of two order-2 expansions
    [9, C], by least squares over sampled directions.  ``dirs`` [n, 3]:
    the unnormalised standard normal draw of the directions (JAX's
    ``normal(key, (n_dirs, 3))``), else ``n_dirs`` drawn by a generator
    seeded 0.  ``coeffs_b9`` may be [9, R, C], R right-hand sides solved
    in one call ([9, R, C] out)."""
    dev = coeffs_a9.device
    if dirs is None:
        dirs = torch.randn((n_dirs, 3), device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
    d = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    basis = sh_encode(d, 3)                                  # [n, 9]
    C = coeffs_a9.shape[-1]
    va = basis @ coeffs_a9                                   # [n, C]
    vb = (basis @ coeffs_b9.reshape(9, -1)).reshape(len(d), -1, C)
    target = (va[:, None, :] * vb).reshape(len(d), -1)
    sol = torch.linalg.lstsq(basis, target).solution         # [9, R * C]
    return sol.reshape(coeffs_b9.shape[:1] + coeffs_b9.shape[1:])


def apply(params, geo_feat: torch.Tensor, normals_primary: torch.Tensor,
          view_dirs: torch.Tensor, cfg: SHLightConfig, *,
          normals_secondary=None, shade_visibility: bool = False,
          gamma=None, env_import=None, env_import_vis=None, probes=None):
    """Shade points: returns (full, specular, diffuse, albedo), each
    [N, 3], under the learned environment, or under an imported one:
    ``env_import`` [n, C] (SH coefficients), and with
    ``shade_visibility`` the per-probe products ``env_import_vis``
    [P, 9, C] at ``probes`` [P, 3], each point reading the probe of
    largest dot product with ``normals_secondary`` (first on ties)."""
    N = geo_feat.shape[0]
    if env_import is not None:
        if shade_visibility and env_import_vis is not None \
                and probes is not None:
            pid = torch.argmax(torch.sum(
                normals_secondary[:, None, :] * probes[None], -1), dim=-1)
            env = env_import_vis[pid]                        # [N, 9, C]
        else:
            env = env_import.expand(N, *env_import.shape)
    else:
        env = params["env_shs"].expand(N, *params["env_shs"].shape)
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


# ---------------------------------------------------------------------------
# imported environments (host-side preparation)
# ---------------------------------------------------------------------------

def image_to_envmap(path: str, force_white: bool = True,
                    gamma: float = 2.4) -> np.ndarray:
    """An image file as a linear-radiance equirect envmap [H, W, 3] f32:
    divided by 255 where its largest value exceeds 1.5 (a 16-bit PNG
    too, as in JAX), raised to ``gamma``, grey with ``force_white``.  A
    PNG reads as imageio reads it (``data.images.read_png``: 16-bit gray
    kept); another format through ``data.images.load_image``."""
    from ...data import images

    with open(path, "rb") as f:
        png = f.read(8) == images.PNG_SIGNATURE
    img = (images.read_png(path) if png
           else images.load_image(path)).astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    img = img[..., :3] ** gamma
    if force_white:
        img = np.repeat(img.mean(-1, keepdims=True), 3, axis=-1)
    return img


def envmap_to_sh(envmap: np.ndarray, sh_order: int = 3) -> np.ndarray:
    """SH coefficients [(order+1)^2, C] (f64) of an equirect envmap
    [H, W, C] by solid-angle-weighted integration over its pixel centres
    (the f32 basis of ``sh_encode``, as in JAX)."""
    H, W = envmap.shape[:2]
    theta = (np.arange(H) + 0.5) / H * np.pi
    phi = (np.arange(W) + 0.5) / W * 2 * np.pi
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                     np.sin(tt) * np.sin(pp)], -1).reshape(-1, 3)
    d_omega = (np.sin(tt) * (np.pi / H) * (2 * np.pi / W)).reshape(-1)
    basis = sh_encode(torch.as_tensor(dirs, dtype=torch.float32),
                      sh_order + 1).numpy()
    vals = envmap.reshape(-1, envmap.shape[-1])
    return np.einsum("nk,n,nc->kc", basis, d_omega, vals)


def build_visibility_probes(env_shs9, *, res: int = 8, dirs=None,
                            device: torch.device | str = "cuda"):
    """Per-probe visibility-modulated environments: (env_vis
    [res^2, 9, 3], probes [res^2, 3]) on ``device``.  Each probe's
    environment is the product of the first 9 coefficients and the
    visibility lobe turned to the probe, fitted over the same
    directions (``dirs``, see ``fit_product_shs``) in one solve."""
    h = w = res
    phi = np.linspace(np.pi / h, np.pi, h)
    theta = np.linspace(-0.5 * np.pi, 1.5 * np.pi, w)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    probes = np.stack([np.cos(tt) * np.sin(pp), np.cos(pp),
                       np.sin(tt) * np.sin(pp)], -1).reshape(-1, 3)
    probes_t = torch.as_tensor(probes, dtype=torch.float32, device=device)
    vis = zonal_rotate(_VIS_ZONAL, probes_t)                 # [P, 9]
    env = torch.as_tensor(np.asarray(env_shs9, np.float32),
                          device=device)[:9]
    env = env.expand(9, 3)
    rhs = vis.T[:, :, None].expand(9, len(probes), 3)        # [9, P, 3]
    sol = fit_product_shs(env, rhs, dirs=dirs)               # [9, P, 3]
    return sol.permute(1, 0, 2).contiguous(), probes_t
