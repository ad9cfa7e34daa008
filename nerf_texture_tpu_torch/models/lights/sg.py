"""Spherical-Gaussian environment light + Cook-Torrance BRDF (port of
``nerf_texture_tpu/models/lights/sg.py``).

The PhySG shading model: the environment is a mixture of M spherical
Gaussians (lobe, sharpness lambda, amplitude mu), the specular NDF an SG
warped into the reflection frame with Fresnel and geometric factors, SG
products by the lambda trick, and the clamped-cosine hemisphere integral
in its closed-form approximation.  All maths is batched over
[..., M, K] lobe / material grids.

``envmap_to_sg`` fits lobes to an equirect environment by Adam on the
rasterisation loss; its initial sharpness draw is an argument (a seeded
``torch.Generator``'s by default), so a test can hand it JAX's draw.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ...utils.mlp import apply_mlp, init_mlp

TINY = 1e-8


@dataclasses.dataclass(frozen=True)
class SGLightConfig:
    """Every field of the JAX SGLightConfig."""

    input_dim: int = 15
    num_lgt_sgs: int = 8
    num_brdf_sgs: int = 1
    white_light: bool = True
    white_specular: bool = True
    hidden: int = 64
    num_layers: int = 3


def fibonacci_sphere(n: int) -> np.ndarray:
    """n roughly uniform unit directions (golden-angle spiral), f32."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = math.pi * (3.0 - math.sqrt(5.0)) * i
    y = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    return np.stack([np.cos(phi) * r, y, np.sin(phi) * r],
                    -1).astype(np.float32)


def sg_energy(lobes, lambdas, mus):
    """Total energy of SG lobes: mu 2 pi / lambda (1 - exp(-2 lambda))."""
    return mus * 2.0 * math.pi / lambdas * (1.0 - torch.exp(-2.0 * lambdas))


def init(generator: torch.Generator, cfg: SGLightConfig) -> dict[str, Any]:
    """Seeded params on the generator's device: {"lgt_sgs" [M, 5 or 7]
    (Fibonacci lobes, lambda 20 + |100 z|, mu |z| scaled to a total
    energy of 2 pi), "specular_reflectance" [K, 1 or 3], "roughness"
    [K, 1] (U(0.04, 0.05) from numpy's seed 0, as in JAX), "albedo_net",
    and with K > 1 "blend_net"}.  As in JAX, a white light's mu is the
    same draw as its lambda."""
    dev = generator.device
    mu_dim = 1 if cfg.white_light else 3
    z = torch.randn((cfg.num_lgt_sgs, 1), generator=generator, device=dev)
    lambdas = 20.0 + torch.abs(z * 100.0)
    mus = torch.abs(z if mu_dim == 1 else torch.randn(
        (cfg.num_lgt_sgs, mu_dim), generator=generator, device=dev))
    energy = sg_energy(None, lambdas, mus)
    mus = mus / torch.sum(energy, dim=0, keepdim=True) * 2.0 * math.pi
    lobes = torch.as_tensor(fibonacci_sphere(cfg.num_lgt_sgs), device=dev)
    dims = [cfg.input_dim] + [cfg.hidden] * (cfg.num_layers - 1)
    params = {
        "lgt_sgs": torch.cat([lobes, lambdas, mus], dim=-1),
        "specular_reflectance": torch.abs(torch.randn(
            (cfg.num_brdf_sgs, 1 if cfg.white_specular else 3),
            generator=generator, device=dev)),
        "roughness": torch.as_tensor(np.random.default_rng(0).uniform(
            4e-2, 5e-2, (cfg.num_brdf_sgs, 1)).astype(np.float32),
            device=dev),
        "albedo_net": init_mlp(generator, dims + [3], bias=True),
    }
    if cfg.num_brdf_sgs > 1:
        params["blend_net"] = init_mlp(generator, dims + [cfg.num_brdf_sgs],
                                       bias=True)
    return params


def hemisphere_int(lam, cos_beta):
    """Closed-form hemispherical integral of an SG against the horizon
    (the numerically stable form); both branches of the select are
    evaluated, as in JAX."""
    lam = lam + TINY
    inv = 1.0 / lam
    t = torch.sqrt(lam) * (1.6988 + 10.8438 * inv) / (
        1.0 + 6.2201 * inv + 10.2415 * inv * inv)
    inv_a = torch.exp(-t)
    inv_b = torch.exp(-t * torch.clamp(cos_beta, min=0.0))
    s1 = (1.0 - inv_a * inv_b) / (1.0 - inv_a + inv_b - inv_a * inv_b)
    b = torch.exp(t * torch.clamp(cos_beta, max=0.0))
    s2 = (b - inv_a) / ((1.0 - inv_a) * (b + 1.0))
    s = torch.where(cos_beta >= 0, s1, s2)
    A_b = 2.0 * math.pi / lam * (torch.exp(-lam) - torch.exp(-2.0 * lam))
    A_u = 2.0 * math.pi / lam * (1.0 - torch.exp(-lam))
    return A_b * (1.0 - s) + A_u * s


def lambda_trick(lobe1, lam1, mu1, lobe2, lam2, mu2):
    """The product of two SGs as one SG (assumes lam1 << lam2)."""
    ratio = lam1 / lam2
    dot = torch.sum(lobe1 * lobe2, dim=-1, keepdim=True)
    tmp = torch.sqrt(ratio * ratio + 1.0 + 2.0 * ratio * dot)
    tmp = torch.minimum(tmp, ratio + 1.0)
    lam3 = lam2 * tmp
    diff = lam2 * (tmp - ratio - 1.0)
    lobes = (ratio / tmp) * lobe1 + (1.0 / tmp) * lobe2
    mus = mu1 * mu2 * torch.exp(diff)
    return lobes, lam3, mus


_COS_MU, _COS_LAM, _COS_ALPHA = 32.7080, 0.0315, 31.7003


def _normalize(v):
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + TINY)


def render_with_sg(lgt_sgs, specular_reflectance, roughness, diffuse_albedo,
                   normal, viewdirs, blending_weights=None):
    """PhySG shading: lgt_sgs [M, 7], specular_reflectance [K, 3],
    roughness [K, 1], diffuse_albedo / normal / viewdirs [..., 3]
    (blending_weights [..., K] mixes the K BRDF lobes).  Returns (rgb,
    specular, diffuse, diffuse_albedo), each [..., 3]."""
    M = lgt_sgs.shape[0]
    K = specular_reflectance.shape[0]
    dots = normal.shape[:-1]
    n = normal[..., None, None, :].expand(*dots, M, K, 3)
    v = viewdirs[..., None, None, :].expand(*dots, M, K, 3)
    sgs = lgt_sgs[..., :, None, :].expand(*dots, M, K, 7)
    lobes = _normalize(sgs[..., :3])
    lams = torch.abs(sgs[..., 3:4])
    mus = torch.abs(sgs[..., 4:7])

    # specular: the SG NDF warped into the reflection frame
    inv_r4 = 1.0 / (roughness ** 4)                           # [K, 1]
    brdf_lam = (2.0 * inv_r4).expand(*dots, M, K, 1)
    brdf_mu = (inv_r4 / math.pi).expand(*dots, M, K, 3)
    v_dot_lobe = torch.clamp(torch.sum(n * v, dim=-1, keepdim=True), min=0.0)
    warp_lobe = _normalize(2.0 * v_dot_lobe * n - v)
    warp_lam = brdf_lam / (4.0 * v_dot_lobe + TINY)
    half = _normalize(warp_lobe + v)
    v_dot_h = torch.clamp(torch.sum(v * half, dim=-1, keepdim=True), min=0.0)
    F0 = specular_reflectance.expand(*dots, M, K, 3)
    Fr = F0 + (1.0 - F0) * torch.pow(
        2.0, -(5.55473 * v_dot_h + 6.8316) * v_dot_h)
    dot1 = torch.clamp(torch.sum(warp_lobe * n, dim=-1, keepdim=True),
                       min=0.0)
    dot2 = torch.clamp(torch.sum(v * n, dim=-1, keepdim=True), min=0.0)
    k_g = (roughness + 1.0) ** 2 / 8.0
    G = (dot1 / (dot1 * (1 - k_g) + k_g + TINY)) \
        * (dot2 / (dot2 * (1 - k_g) + k_g + TINY))
    warp_mu = brdf_mu * Fr * G / (4.0 * dot1 * dot2 + TINY)
    f_lobe, f_lam, f_mu = lambda_trick(lobes, lams, mus, warp_lobe,
                                       warp_lam, warp_mu)
    p_lobe, p_lam, p_mu = lambda_trick(n, _COS_LAM, _COS_MU, f_lobe, f_lam,
                                       f_mu)
    d1 = torch.sum(p_lobe * n, dim=-1, keepdim=True)
    d2 = torch.sum(f_lobe * n, dim=-1, keepdim=True)
    spec = p_mu * hemisphere_int(p_lam, d1) \
        - f_mu * _COS_ALPHA * hemisphere_int(f_lam, d2)
    if blending_weights is None:
        spec = torch.sum(spec, dim=(-2, -3))
    else:
        spec = torch.sum(torch.sum(spec, dim=-3)
                         * blending_weights[..., None], dim=-2)
    spec = torch.clamp(spec, min=0.0)

    # diffuse: albedo / pi against the cosine lobe
    dif_mu = mus[..., :1, :] * (diffuse_albedo / math.pi)[..., None, None, :]
    dl, dlam, dmu = lambda_trick(n[..., :1, :], _COS_LAM, _COS_MU,
                                 lobes[..., :1, :], lams[..., :1, :], dif_mu)
    dd1 = torch.sum(dl * n[..., :1, :], dim=-1, keepdim=True)
    dd2 = torch.sum(lobes[..., :1, :] * n[..., :1, :], dim=-1, keepdim=True)
    diffuse = dmu * hemisphere_int(dlam, dd1) \
        - dif_mu * _COS_ALPHA * hemisphere_int(lams[..., :1, :], dd2)
    diffuse = torch.clamp(torch.sum(diffuse, dim=(-2, -3)), min=0.0)
    return spec + diffuse, spec, diffuse, diffuse_albedo


def _white(lgt: torch.Tensor) -> torch.Tensor:
    """A white light's 5 columns -> 7 (mu replicated)."""
    if lgt.shape[-1] == 5:
        lgt = torch.cat([lgt, lgt[..., -1:], lgt[..., -1:]], -1)
    return lgt


def apply(params, geo_feat, normals, view_dirs, cfg: SGLightConfig, *,
          lgt_sgs_import=None, **_):
    """Shade points: (full, specular, diffuse, albedo), each [N, 3].  The
    curved field passes -d as the view directions.  ``lgt_sgs_import``
    [M', 5 or 7] replaces the learned lobes (``envmap_to_sg``)."""
    lgt = _white(params["lgt_sgs"] if lgt_sgs_import is None
                 else lgt_sgs_import)
    albedo = torch.sigmoid(apply_mlp(params["albedo_net"], geo_feat))
    spec_ref = torch.sigmoid(params["specular_reflectance"])
    if spec_ref.shape[-1] == 1:
        spec_ref = spec_ref.expand(spec_ref.shape[0], 3)
    rough = torch.sigmoid(params["roughness"])
    blend = None
    if "blend_net" in params:
        blend = torch.softmax(apply_mlp(params["blend_net"], geo_feat),
                              dim=-1)
    return render_with_sg(lgt, spec_ref, rough, albedo, normals, view_dirs,
                          blending_weights=blend)


def _equirect_dirs(H: int, W: int, device) -> torch.Tensor:
    """[H, W, 3] directions of an equirect map: theta in [0, pi] from +y,
    phi in [-pi, pi]."""
    theta = torch.linspace(0, math.pi, H, device=device)
    phi = torch.linspace(-math.pi, math.pi, W, device=device)
    tt, pp = torch.meshgrid(theta, phi, indexing="ij")
    return torch.stack([torch.sin(tt) * torch.cos(pp), torch.cos(tt),
                        torch.sin(tt) * torch.sin(pp)], -1)


def envmap_to_sg(envmap, num_sgs: int = 32, iterations: int = 500,
                 lr: float = 1e-2, *, lambda_draw=None,
                 device: torch.device | str = "cuda") -> torch.Tensor:
    """Fit ``num_sgs`` SG lobes [num_sgs, 7] to an equirect envmap
    [H, W, 3] by ``iterations`` Adam steps on the mean squared
    rasterisation error.  Start: Fibonacci lobes, lambda 20 + |20 z| with
    z = ``lambda_draw`` [num_sgs, 1] (where not given, a standard normal
    draw of a generator seeded 0), mu the map's mean / num_sgs."""
    env = torch.as_tensor(np.asarray(envmap, np.float32), device=device)
    H, W = env.shape[:2]
    dirs = _equirect_dirs(H, W, env.device).reshape(-1, 3)
    target = env.reshape(-1, 3)
    if lambda_draw is None:
        lambda_draw = torch.randn(
            (num_sgs, 1), device=env.device,
            generator=torch.Generator(env.device).manual_seed(0))
    z = torch.as_tensor(lambda_draw, dtype=torch.float32, device=env.device)
    lobes = torch.as_tensor(fibonacci_sphere(num_sgs), device=env.device)
    lams = 20.0 + torch.abs(z * 20.0)
    mus = torch.full((num_sgs, 3), float(torch.mean(target)) / num_sgs,
                     device=env.device)
    p = torch.cat([lobes, lams, mus], -1).requires_grad_(True)
    opt = torch.optim.Adam([p], lr=lr)
    for _ in range(iterations):
        lb = _normalize(p[:, :3])
        rgb = torch.exp(torch.abs(p[:, 3:4])[:, 0][None]
                        * (dirs @ lb.T - 1.0)) @ torch.abs(p[:, 4:7])
        loss = torch.mean((rgb - target) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return p.detach()


def sg_to_envmap(lgt_sgs, H: int = 128, W: int = 256):
    """Rasterise an SG mixture [M, 5 or 7] to an equirect envmap:
    (rgb [H, W, 3], dirs [H, W, 3])."""
    dirs = _equirect_dirs(H, W, lgt_sgs.device)
    lgt_sgs = _white(lgt_sgs)
    lobes = _normalize(lgt_sgs[:, :3])
    lams = torch.abs(lgt_sgs[:, 3:4])
    mus = torch.abs(lgt_sgs[:, 4:7])
    dots = torch.einsum("hwc,mc->hwm", dirs, lobes)
    rgb = torch.einsum("hwm,mc->hwc", torch.exp(lams[:, 0] * (dots - 1.0)),
                       mus)
    return rgb, dirs
