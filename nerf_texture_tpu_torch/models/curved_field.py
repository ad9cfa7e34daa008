"""The NeRF-Texture curved-surface field (port of
``nerf_texture_tpu/models/curved_field.py``).

MeshFeatureField -> sigma MLP (embed -> hidden -> 1 + geo_feat_dim) ->
the SH light model (or, with ``light_model='None'``, a colour MLP over
the SH-encoded reflection direction).  ``forward`` shades every sample in
one pass, at inference or in training (noisy features and the
-grad(sigma) normal target); ``sigma_with_aux`` and ``color_from_aux``
are the two phases of the pool render: sigma over the whole pool, colour
only on the survivors, reusing the sigma pass's embedding;
``forward_baked`` reads the embeddings from a baked atlas.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP item):
the SG and Envmap light models and imported environments (item 11.1),
the visual modes other than RGB and the light rotation of the viewer
(item 11.7), the camera regulariser (item 11.4), and the deferred
shading of the baked atlas (``forward_baked_s1`` / ``_s2``, item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.activation import trunc_exp
from ..ops.encoding import freq_encode, sh_encode, sh_encode_dim
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


def _sigma_grad_normal(params, state: MeshFieldState, x: torch.Tensor,
                       cfg: CurvedFieldConfig, rt, mode: str, noise, frames):
    """The field at x with the normal target -grad_x of the remapped
    density (1 - exp(-lambda sigma)) / lambda: (FieldOutput, sigma, geo
    features, normalised -grad [N, 3]).

    The target only ever enters the loss detached (it is the cosine
    loss's target, and the shell mask reads whether it is finite), so
    its own derivative in the params is never needed: one first-order
    ``autograd.grad`` at x.detach(), keeping the graph that the training
    loss then backpropagates through sigma."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        fout = mesh_field.apply(params["field"], state, xg, cfg.field, rt,
                                mode=mode, noise=noise, no_noise=False,
                                requires_grad_xyz=True, frames=frames)
        sigma, geo_feat = _sigma_from_embed(params, fout.embed)
        remap = (1.0 / SIGMA_REMAP_LAMBDA
                 * (1.0 - torch.exp(-SIGMA_REMAP_LAMBDA * sigma)))
        (grad_x,) = torch.autograd.grad(remap.sum(), xg, retain_graph=True)
    return fout, sigma, geo_feat, _normalize(-grad_x)


def forward(params, state: MeshFieldState, x: torch.Tensor,
            d: torch.Tensor, cfg: CurvedFieldConfig,
            rt: FieldRuntime | None = None, *, mode: str = "none",
            noise: torch.Tensor | None = None, training: bool = False,
            euler_rot=None, visual_mode: str = "RGB",
            light_visual_mode: str = "Full", gamma=None, light_import=None,
            frames=None):
    """(sigma [N], color [N, 3], extras) through the anchor frames.

    Inference (extras {}): noise-free features, the visual and light
    modes as asked.  ``training``: the features get the probabilistic
    ``noise`` [N, L * C] (with ``prob_model``), the colour is the full
    shading of the RGB mode, and with a light model the normals come in
    pairs: extras['normal'] is the fine (predicted) normal, and
    extras['normal_grad'] its target, the -grad(sigma) normal smoothed
    toward the coarse normal by ``smooth_grad_weight`` and detached;
    samples whose -grad(sigma) is not finite leave the shell mask."""
    if training:
        _check_view("RGB", None, light_import)
    else:
        _check_view(visual_mode, euler_rot, light_import)
    extras = {}
    normal_grad = None
    if training and cfg.render_light_model:
        fout, sigma, geo_feat, normal_grad = _sigma_grad_normal(
            params, state, x, cfg, rt, mode, noise, frames)
        h_mask = fout.h_mask & torch.all(torch.isfinite(normal_grad), dim=-1)
    else:
        fout = mesh_field.apply(params["field"], state, x, cfg.field, rt,
                                mode=mode, noise=noise,
                                no_noise=not training, frames=frames)
        sigma, geo_feat = _sigma_from_embed(params, fout.embed)
        h_mask = fout.h_mask
    normal_coarse = fout.normal_coarse
    normal = fout.normal_fine if cfg.render_light_model else normal_coarse
    if cfg.render_light_model and rt is not None \
            and rt.fc_weight is not None:
        normal = rt.fc_weight * normal + (1.0 - rt.fc_weight) * normal_coarse
    normal = _normalize(normal)
    if normal_grad is not None:
        w = cfg.smooth_grad_weight
        extras["normal"] = fout.normal_fine
        extras["normal_grad"] = _normalize(normal_grad.detach() * (1 - w)
                                           + normal_coarse * w)
    color = _light_or_color(params, geo_feat, normal, normal_coarse, d, cfg,
                            "Full" if training else light_visual_mode,
                            gamma=gamma)
    sigma = torch.where(h_mask, sigma, 0.0)
    color = torch.where(h_mask[..., None], color, 0.0)
    return sigma, color, extras


def forward_baked(params, bake, x: torch.Tensor, d: torch.Tensor,
                  cfg: CurvedFieldConfig, rt: FieldRuntime | None, frames, *,
                  light_visual_mode: str = "Full", euler_rot=None,
                  light_import=None):
    """Inference forward through a baked feature atlas
    (``render.baked``): one corner-packed atlas row per sample replaces
    the hash-pyramid and phi-grid encodes; the sigma MLP, normal net and
    light model are those of ``forward``.  frames: the anchor frames with
    tile addressing (``baked.anchor_frames_ext``) or without.  Mode
    'none', RGB: (sigma [N], color [N, 3]), zero outside the shell and
    the baked tiles."""
    from ..render import baked as baked_mod

    _check_view("RGB", euler_rot, light_import)
    fcfg = cfg.field
    normal_coarse = _normalize(frames["normal"])
    h = torch.sum((x - frames["p0"]) * normal_coarse, dim=-1, keepdim=True)
    vals, tile_ok = baked_mod.lookup(bake, frames, x)
    F = fcfg.encoder_f_out_dim
    x_embed, phi_embed = vals[:, :F], vals[:, F:]
    z_embed = freq_encode(h, fcfg.z_multires)
    sigma, geo_feat = _sigma_from_embed(params,
                                        torch.cat([x_embed, z_embed], -1))
    h_mask = (torch.abs(h[..., 0]) < fcfg.h_threshold) & frames["hit"] \
        & tile_ok
    color = _baked_shade(params, x_embed, phi_embed, z_embed, geo_feat,
                         frames["tbn"], normal_coarse, d, cfg, rt,
                         light_visual_mode=light_visual_mode)
    return (torch.where(h_mask, sigma, 0.0),
            torch.where(h_mask[..., None], color, 0.0))


def _baked_shade(params, x_embed, phi_embed, z_embed, geo_feat, tbn,
                 normal_coarse, d, cfg: CurvedFieldConfig,
                 rt: FieldRuntime | None, *, light_visual_mode: str = "Full"):
    """The shading of ``forward_baked``: the normal net on the baked
    embeddings, the fine / coarse blend, the light model or colour MLP."""
    fcfg = cfg.field
    if fcfg.pred_normal:
        nf_local = normal_net.apply(params["field"]["normal"], z_embed,
                                    x_embed, fcfg.normal_cfg,
                                    phi_embed=phi_embed)
        nf = _normalize(torch.einsum("nba,nb->na", tbn, nf_local))
    else:
        nf = normal_coarse
    normal = nf if cfg.render_light_model else normal_coarse
    if cfg.render_light_model and rt is not None \
            and rt.fc_weight is not None:
        normal = _normalize(rt.fc_weight * normal
                            + (1.0 - rt.fc_weight) * normal_coarse)
    return _light_or_color(params, geo_feat, normal, normal_coarse, d, cfg,
                           light_visual_mode)


def regular_loss(params, cfg: CurvedFieldConfig, step=None, *,
                 optimize_camera_loss=None, level: int | None = None,
                 camera_reg_weight=None):
    """The training regularisers: the field's (1e-8 x clustering at
    ``level``) and, with the Lipschitz normal net under a light model,
    1e-4 x its Lipschitz bound."""
    if optimize_camera_loss is not None:
        raise NotImplementedError(
            "curved_field.regular_loss: the camera regulariser belongs to "
            "camera optimisation, which is not ported; ROADMAP Queue 1, "
            "item 11.4")
    loss = mesh_field.regular_loss(params["field"], cfg.field, level=level)
    if cfg.field.lip and cfg.render_light_model and cfg.field.pred_normal:
        loss = loss + 1e-4 * normal_net.regularization(
            params["field"]["normal"])
    return loss


def _not_ported(name: str, item: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"curved_field.{name} is not ported; ROADMAP Queue 1, item "
            f"{item}")
    fn.__name__ = name
    return fn


# deferred shading of the baked atlas (the JAX package's stages 1 and 2)
forward_baked_s1 = _not_ported("forward_baked_s1", "12")
forward_baked_s2 = _not_ported("forward_baked_s2", "12")
