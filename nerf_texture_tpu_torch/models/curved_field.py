"""The NeRF-Texture curved-surface field (port of the inference path of
``nerf_texture_tpu/models/curved_field.py``).

MeshFeatureField -> sigma MLP (embed -> hidden -> 1 + geo_feat_dim) ->
the SH light model (or, with ``light_model='None'``, a colour MLP over
the SH-encoded reflection direction).  ``forward`` shades every sample in
one pass; ``sigma_with_aux`` and ``color_from_aux`` are the two phases of
the pool render: sigma over the whole pool, colour only on the survivors,
reusing the sigma pass's embedding.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP item):
training (the -grad(sigma) normals through a double backward and the
regularisers, item 9), the SG and Envmap light models and imported
environments (item 11.1), the visual modes other than RGB and the light
rotation of the viewer (item 11.7), and the baked forward (item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.activation import trunc_exp
from ..ops.encoding import sh_encode, sh_encode_dim
from ..utils.mlp import apply_mlp, init_mlp
from . import mesh_field, normal_net
from .lights import sh as sh_light
from .mesh_field import FieldRuntime, MeshFieldConfig, MeshFieldState

SIGMA_REMAP_LAMBDA = 5e-2


@dataclasses.dataclass(frozen=True)
class CurvedFieldConfig:
    """Every field of the JAX CurvedFieldConfig."""

    field: MeshFieldConfig = MeshFieldConfig()
    num_layers: int = 2
    hidden_dim: int = 32
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    dir_degree: int = 4
    light_model: str = "SH"     # 'SH' | 'SG' | 'Envmap' | 'None'
    smooth_grad_weight: float = 1e-1
    no_visibility: bool = False
    bound: float = 1.0
    sh_order: int = 3
    use_specular: bool = True
    white_light: bool = True
    num_lgt_sgs: int = 8
    num_brdf_sgs: int = 1
    white_specular: bool = True
    env_res: int = 16

    @property
    def render_light_model(self) -> bool:
        return self.light_model in ("SH", "SG", "Envmap")

    @property
    def sh_cfg(self) -> sh_light.SHLightConfig:
        return sh_light.SHLightConfig(
            input_dim=self.geo_feat_dim, sh_order=self.sh_order,
            white_light=self.white_light, use_specular=self.use_specular)

    @property
    def field_name(self) -> str:
        """Config-encoding name of checkpoints and field files."""
        name = "curved_grid"
        if self.field.encoder_type == "hash":
            name += "_hash"
        if self.field.clustering:
            name += "_clus"
        if self.field.prob_model:
            name += "_prob"
        if self.field.lip:
            name += "_lip"
        name += "_" + self.light_model
        if self.no_visibility:
            name += "_novis"
        if self.field.bound_output_normal:
            name += "_bd"
        return name


def _check_light(cfg: CurvedFieldConfig):
    if cfg.light_model in ("SG", "Envmap"):
        raise NotImplementedError(
            f"curved_field: the {cfg.light_model} light model is not ported; "
            f"ROADMAP Queue 1, item 11.1")


def init(generator: torch.Generator, cfg: CurvedFieldConfig) -> dict[str, Any]:
    """Seeded params on the generator's device: {"field", "sigma_net",
    "light" (SH) or "color_net" (no light model)}."""
    _check_light(cfg)
    params = {"field": mesh_field.init(generator, cfg.field)}
    sigma_dims = ([cfg.field.embed_dim] + [cfg.hidden_dim]
                  * (cfg.num_layers - 1) + [1 + cfg.geo_feat_dim])
    params["sigma_net"] = init_mlp(generator, sigma_dims, bias=True)
    if cfg.render_light_model:
        params["light"] = sh_light.init(generator, cfg.sh_cfg)
    else:
        color_in = (sh_encode_dim(cfg.dir_degree) + cfg.geo_feat_dim
                    if cfg.dir_degree > 0 else cfg.geo_feat_dim)
        params["color_net"] = init_mlp(
            generator, [color_in] + [cfg.hidden_dim_color]
            * (cfg.num_layers_color - 1) + [3], bias=True)
    return params


def _sigma_from_embed(params, embed: torch.Tensor):
    h = apply_mlp(params["sigma_net"], embed)
    return trunc_exp(h[..., 0]), h[..., 1:]


def density(params, state: MeshFieldState, x: torch.Tensor,
            cfg: CurvedFieldConfig, rt: FieldRuntime | None = None, *,
            mode: str = "none", noise=None, frames=None):
    """(sigma [N] zero outside the shell, geo features [N, G]); noise-free
    unless a feature ``noise`` draw is given."""
    out = mesh_field.apply(params["field"], state, x, cfg.field, rt,
                           mode=mode, noise=noise, no_noise=noise is None,
                           need_normals=False, frames=frames)
    sigma, geo_feat = _sigma_from_embed(params, out.embed)
    return torch.where(out.h_mask, sigma, 0.0), geo_feat


def sigma_with_aux(params, state: MeshFieldState, x: torch.Tensor,
                   d: torch.Tensor, cfg: CurvedFieldConfig,
                   rt: FieldRuntime | None = None, *, mode: str = "none",
                   frames=None):
    """Sigma phase of the pool render: (sigma [N], aux) where aux keeps
    the embedding, geo features and shell mask for ``color_from_aux``."""
    out = mesh_field.apply(params["field"], state, x, cfg.field, rt,
                           mode=mode, no_noise=True, need_normals=False,
                           frames=frames)
    sigma, geo_feat = _sigma_from_embed(params, out.embed)
    sigma = torch.where(out.h_mask, sigma, 0.0)
    return sigma, {"geo": geo_feat, "embed": out.embed,
                   "h_mask": out.h_mask}


def _check_view(visual_mode: str, euler_rot, light_import):
    if visual_mode != "RGB":
        raise NotImplementedError(
            f"curved_field: visual mode {visual_mode!r} is not ported (RGB "
            f"only); ROADMAP Queue 1, item 11.7")
    if euler_rot is not None:
        raise NotImplementedError(
            "curved_field: the light rotation (euler_rot) is not ported; "
            "ROADMAP Queue 1, item 11.7")
    if light_import is not None:
        raise NotImplementedError(
            "curved_field: imported environments are not ported; ROADMAP "
            "Queue 1, item 11.1")


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-5)


def _light_or_color(params, geo_feat, normal, normal_coarse, d,
                    cfg: CurvedFieldConfig, light_visual_mode: str,
                    gamma=None):
    """The colour of the shading normal: the light model's output
    ``light_visual_mode``, or the colour MLP without a light model."""
    if cfg.render_light_model:
        full, spec, dif, alb = shade(params, geo_feat, normal.detach(), d,
                                     cfg, normal_secondary=normal_coarse,
                                     gamma=gamma)
        return {"Full": full, "Specular": spec, "Diffuse": dif,
                "Albedo": alb}[light_visual_mode]
    if cfg.dir_degree > 0:
        dn = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-5)
        wr = 2.0 * torch.sum(-dn * normal, -1, keepdim=True) * normal + dn
        h = torch.cat([sh_encode(wr, cfg.dir_degree), geo_feat], -1)
    else:
        h = geo_feat
    return torch.sigmoid(apply_mlp(params["color_net"], h))


def color_from_aux(params, state: MeshFieldState, x: torch.Tensor,
                   d: torch.Tensor, aux, cfg: CurvedFieldConfig,
                   rt: FieldRuntime | None, frames, *,
                   visual_mode: str = "RGB",
                   light_visual_mode: str = "Full", light_import=None,
                   euler_rot=None):
    """Colour phase of the pool render over the survivors, from the sigma
    phase's aux (embedding, geo features, shell mask) and the survivors'
    anchor frames: the phi grid at p_sur, the normal net, the TBN
    rotation, the light model.  [N, 3], zero outside the shell."""
    _check_view(visual_mode, euler_rot, light_import)
    fcfg = cfg.field
    F = fcfg.encoder_f_out_dim
    x_embed = aux["embed"][..., :F]
    z_embed = aux["embed"][..., F:]
    n = frames["normal"]
    normal_coarse = _normalize(n)
    if fcfg.pred_normal:
        h = torch.sum((x - frames["p0"]) * n, dim=-1, keepdim=True)
        p_sur = x - h * n
        ncfg = fcfg.normal_cfg
        nparams = params["field"]["normal"]
        phi_embed = normal_net.phi_embedding(nparams, p_sur, ncfg,
                                             amp=fcfg.infer_table_bf16)
        nf_local = normal_net.apply(nparams, z_embed, x_embed, ncfg,
                                    phi_embed=phi_embed)
        nf = _normalize(torch.einsum("nba,nb->na", frames["tbn"], nf_local))
    else:
        nf = normal_coarse
    normal = nf if cfg.render_light_model else normal_coarse
    if cfg.render_light_model and rt is not None \
            and rt.fc_weight is not None:
        # fine/coarse blend, as in `forward`
        normal = _normalize(rt.fc_weight * normal
                            + (1.0 - rt.fc_weight) * normal_coarse)
    color = _light_or_color(params, aux["geo"], normal, normal_coarse, d,
                            cfg, light_visual_mode)
    return torch.where(aux["h_mask"][..., None], color, 0.0)


def shade(params, geo_feat, normal_primary, view_dirs,
          cfg: CurvedFieldConfig, *, normal_secondary=None,
          shade_visibility: bool = True, gamma=None, light_import=None):
    """Run the light model: (full, specular, diffuse, albedo)."""
    _check_light(cfg)
    if light_import:
        raise NotImplementedError(
            "curved_field.shade: imported environments are not ported; "
            "ROADMAP Queue 1, item 11.1")
    return sh_light.apply(
        params["light"], geo_feat, normal_primary, view_dirs, cfg.sh_cfg,
        normals_secondary=normal_secondary,
        shade_visibility=shade_visibility and not cfg.no_visibility,
        gamma=gamma)


def forward(params, state: MeshFieldState, x: torch.Tensor,
            d: torch.Tensor, cfg: CurvedFieldConfig,
            rt: FieldRuntime | None = None, *, mode: str = "none",
            training: bool = False, euler_rot=None,
            visual_mode: str = "RGB", light_visual_mode: str = "Full",
            gamma=None, light_import=None, frames=None):
    """Inference forward: (sigma [N], color [N, 3], extras {}) through
    the anchor frames."""
    if training:
        raise NotImplementedError(
            "curved_field.forward: training (the -grad(sigma) normals "
            "through a double backward) is not ported; ROADMAP Queue 1, "
            "item 9")
    _check_view(visual_mode, euler_rot, light_import)
    fout = mesh_field.apply(params["field"], state, x, cfg.field, rt,
                            mode=mode, no_noise=True, frames=frames)
    sigma, geo_feat = _sigma_from_embed(params, fout.embed)
    normal_coarse = fout.normal_coarse
    normal = fout.normal_fine if cfg.render_light_model else normal_coarse
    if cfg.render_light_model and rt is not None \
            and rt.fc_weight is not None:
        normal = rt.fc_weight * normal + (1.0 - rt.fc_weight) * normal_coarse
    normal = _normalize(normal)
    color = _light_or_color(params, geo_feat, normal, normal_coarse, d, cfg,
                            light_visual_mode, gamma=gamma)
    sigma = torch.where(fout.h_mask, sigma, 0.0)
    color = torch.where(fout.h_mask[..., None], color, 0.0)
    return sigma, color, {}


def _not_ported(name: str, item: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"curved_field.{name} is not ported; ROADMAP Queue 1, item "
            f"{item}")
    fn.__name__ = name
    return fn


forward_baked = _not_ported("forward_baked", "10")
regular_loss = _not_ported("regular_loss", "9")
