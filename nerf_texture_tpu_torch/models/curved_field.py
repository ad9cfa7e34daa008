"""The NeRF-Texture curved-surface field (port of
``nerf_texture_tpu/models/curved_field.py``).

MeshFeatureField -> sigma MLP (embed -> hidden -> 1 + geo_feat_dim) ->
a light model (``light_model`` 'SH', 'SG' or 'Envmap'; see
``models/lights``) or, with ``light_model='None'``, a colour MLP over
the SH-encoded reflection direction.  ``forward`` shades every sample in
one pass, at inference or in training (noisy features and the
-grad(sigma) normal target); ``regular_loss`` sums the training
regularisers, the camera term among them; ``sigma_with_aux`` and
``color_from_aux`` are the two phases of the pool render: sigma over the
whole pool, colour only on the survivors, reusing the sigma pass's
embedding; ``forward_baked`` reads the embeddings from a baked atlas.

At inference every path takes the viewer's options: ``light_import``
(an imported environment, ``CurvedTrainer.load_envmap``),
``light_visual_mode`` (Full, Specular, Diffuse or Albedo of the light
model), ``euler_rot`` (a [3, 3] rotation of the view directions and
normals the light model sees) and ``visual_mode`` (RGB, or the
diagnostics UV, Tan, Btan, Fea, Nc, Nf, Grad and the display normal;
``forward_baked`` is RGB only).  ``forward_baked_s1`` and
``forward_baked_s2`` split ``forward_baked`` for deferred shading: sigma
and a flat feature row a sample, then the shading once a ray on the
composited row.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.activation import trunc_exp
from ..ops.encoding import freq_encode, sh_encode, sh_encode_dim
from ..geometry import projector as proj
from ..utils.mlp import apply_mlp, init_mlp
from . import mesh_field, normal_net
from .lights import envmap as envmap_light
from .lights import sg as sg_light
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
    def sg_cfg(self) -> sg_light.SGLightConfig:
        return sg_light.SGLightConfig(
            input_dim=self.geo_feat_dim, num_lgt_sgs=self.num_lgt_sgs,
            num_brdf_sgs=self.num_brdf_sgs, white_light=self.white_light,
            white_specular=self.white_specular)

    @property
    def env_cfg(self) -> envmap_light.EnvmapLightConfig:
        return envmap_light.EnvmapLightConfig(
            input_dim=self.geo_feat_dim, env_res=self.env_res,
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


def init(generator: torch.Generator, cfg: CurvedFieldConfig) -> dict[str, Any]:
    """Seeded params on the generator's device: {"field", "sigma_net",
    "light" (the SH, SG or Envmap model's) or "color_net" (no light
    model)}."""
    params = {"field": mesh_field.init(generator, cfg.field)}
    sigma_dims = ([cfg.field.embed_dim] + [cfg.hidden_dim]
                  * (cfg.num_layers - 1) + [1 + cfg.geo_feat_dim])
    params["sigma_net"] = init_mlp(generator, sigma_dims, bias=True)
    if cfg.light_model == "SH":
        params["light"] = sh_light.init(generator, cfg.sh_cfg)
    elif cfg.light_model == "SG":
        params["light"] = sg_light.init(generator, cfg.sg_cfg)
    elif cfg.light_model == "Envmap":
        params["light"] = envmap_light.init(generator, cfg.env_cfg)
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


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-5)


def _light_or_color(params, geo_feat, normal, normal_coarse, d,
                    cfg: CurvedFieldConfig, light_visual_mode: str,
                    gamma=None, light_import=None):
    """The colour of the shading normal: the light model's output
    ``light_visual_mode``, or the colour MLP without a light model."""
    if cfg.render_light_model:
        full, spec, dif, alb = shade(params, geo_feat, normal.detach(), d,
                                     cfg, normal_secondary=normal_coarse,
                                     gamma=gamma, light_import=light_import)
        return {"Full": full, "Specular": spec, "Diffuse": dif,
                "Albedo": alb}[light_visual_mode]
    if cfg.dir_degree > 0:
        dn = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-5)
        wr = 2.0 * torch.sum(-dn * normal, -1, keepdim=True) * normal + dn
        h = torch.cat([sh_encode(wr, cfg.dir_degree), geo_feat], -1)
    else:
        h = geo_feat
    return torch.sigmoid(apply_mlp(params["color_net"], h))


def _rotate(euler_rot, *vs):
    """Each [N, 3] of ``vs`` turned by the [3, 3] ``euler_rot``."""
    return [torch.einsum("ab,nb->na", euler_rot, v) for v in vs]


def color_from_aux(params, state: MeshFieldState, x: torch.Tensor,
                   d: torch.Tensor, aux, cfg: CurvedFieldConfig,
                   rt: FieldRuntime | None, frames, *,
                   visual_mode: str = "RGB",
                   light_visual_mode: str = "Full", light_import=None,
                   euler_rot=None):
    """Colour phase of the pool render over the survivors, from the sigma
    phase's aux (embedding, geo features, shell mask) and the survivors'
    anchor frames: the phi grid at p_sur, the normal net, the TBN
    rotation, the (rotated) light model.  Every visual mode; 'Grad' (no
    -grad(sigma) at inference) shows the display normal, as ``forward``
    does.  [N, 3], zero outside the shell."""
    fcfg = cfg.field
    F = fcfg.encoder_f_out_dim
    x_embed = aux["embed"][..., :F]
    z_embed = aux["embed"][..., F:]
    n = frames["normal"]
    normal_coarse = _normalize(n)
    mask = aux["h_mask"][..., None]
    if visual_mode == "UV":
        color, uv_mask = uv_visual(state, x, cfg,
                                   rt if rt is not None
                                   else FieldRuntime.default(), "none")
        m = mask if uv_mask is None else (aux["h_mask"] & uv_mask)[..., None]
        return torch.where(m, color, 0.0)
    if visual_mode in ("Tan", "Btan"):
        color = tbn_visual(state, x, cfg, "none",
                           row=0 if visual_mode == "Tan" else 1)
        return torch.where(mask, color, 0.0)
    if visual_mode == "Fea":
        return torch.where(mask, torch.clamp((aux["embed"][..., :3] + 1.0)
                                             / 2.0, 0.0, 1.0), 0.0)
    if visual_mode == "Nc":
        return torch.where(mask, (normal_coarse + 1.0) / 2.0, 0.0)
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
    if visual_mode == "Nf":
        return torch.where(mask, (nf + 1.0) / 2.0, 0.0)
    normal = nf if cfg.render_light_model else normal_coarse
    if cfg.render_light_model and rt is not None \
            and rt.fc_weight is not None:
        # fine/coarse blend, as in `forward`
        normal = _normalize(rt.fc_weight * normal
                            + (1.0 - rt.fc_weight) * normal_coarse)
    if visual_mode != "RGB":
        # 'normal' and any other mode: the display normal
        return torch.where(mask, (normal + 1.0) / 2.0, 0.0)
    if euler_rot is not None:
        d, normal, normal_coarse = _rotate(euler_rot, d, normal,
                                           normal_coarse)
    color = _light_or_color(params, aux["geo"], normal, normal_coarse, d,
                            cfg, light_visual_mode, light_import=light_import)
    return torch.where(mask, color, 0.0)


def uv_visual(state: MeshFieldState, x: torch.Tensor, cfg: CurvedFieldConfig,
              rt: FieldRuntime, mode: str):
    """The UV visual mode: (colour [N, 3] = (u, v, 0), detached; h_mask
    [N] or None).  Mode 'none' reads the template's UVs, 'shape' /
    'unhash' the imported mesh's (the height scaled as in the field),
    'field' the canvas coordinates mapped to [0, 1], 'patch' zeros (a
    point cloud has no UVs)."""
    fcfg = cfg.field
    if mode == "field":
        u = x[..., 0] / state.imported.bounds[0]
        v = x[..., 1] / state.imported.bounds[1]
        sdf = x[..., 2] - rt.sdf_offset
        h_mask = ((torch.abs(sdf) < fcfg.h_threshold)
                  & (torch.abs(u) <= 1.0) & (torch.abs(v) <= 1.0))
        uv = torch.stack([(u + 1.0) / 2.0, (v + 1.0) / 2.0], -1)
    elif mode == "patch":
        return torch.zeros_like(x), None
    else:
        parr = state.projector if mode == "none" else state.projector_imported
        uvh_out, h_mask, _, _ = proj.uvh(parr, x, k=fcfg.k_for_uv,
                                         h_threshold=None)
        sdf = uvh_out[..., 2]
        if mode in ("shape", "unhash"):
            # a tensor divisor divides exactly on CUDA, as in mesh_field
            scale = torch.tensor(max(rt.sdf_scale_factor, 1e-5),
                                 dtype=x.dtype, device=x.device)
            sdf = sdf / scale - rt.sdf_offset
        h_mask = h_mask & (torch.abs(sdf) < fcfg.h_threshold)
        uv = uvh_out[..., :2]
    color = torch.cat([uv, torch.zeros_like(uv[..., :1])], -1)
    return color.detach(), h_mask


def tbn_visual(state: MeshFieldState, x: torch.Tensor, cfg: CurvedFieldConfig,
               mode: str, row: int) -> torch.Tensor:
    """The Tan (row 0) / Btan (row 1) visual modes: the TBN frame's
    tangent or bitangent of the face x projects onto, as (v + 1) / 2,
    detached; 'field' shows the identity frame, 'patch' mid-grey."""
    if mode == "field":
        vec = torch.zeros_like(x)
        vec[..., row] = 1.0
        return (vec + 1.0) / 2.0
    if mode == "patch":
        return torch.full_like(x, 0.5)
    parr = state.projector if mode == "none" else state.projector_imported
    tbn, _ = proj.query_tbn(parr, x, k=cfg.field.k_for_uv,
                            h_threshold=cfg.field.h_threshold)
    return ((tbn[:, row] + 1.0) / 2.0).detach()


def shade(params, geo_feat, normal_primary, view_dirs,
          cfg: CurvedFieldConfig, *, normal_secondary=None,
          shade_visibility: bool = True, gamma=None, light_import=None):
    """Run the light model: (full, specular, diffuse, albedo).  SH reads
    the coarse normal ``normal_secondary`` for its visibility probes,
    Envmap for its hemisphere mask; SG shades with -d as the view
    direction.  ``light_import``: the imported environment's keyword
    arguments of the model (``env_import`` [+ ``env_import_vis``,
    ``probes``], or ``lgt_sgs_import``)."""
    li = light_import or {}
    if cfg.light_model == "SH":
        return sh_light.apply(
            params["light"], geo_feat, normal_primary, view_dirs,
            cfg.sh_cfg, normals_secondary=normal_secondary,
            shade_visibility=shade_visibility and not cfg.no_visibility,
            gamma=gamma, **li)
    if cfg.light_model == "SG":
        return sg_light.apply(params["light"], geo_feat, normal_primary,
                              -view_dirs, cfg.sg_cfg, **li)
    return envmap_light.apply(params["light"], geo_feat, normal_primary,
                              view_dirs, cfg.env_cfg,
                              normal_coarse=normal_secondary, gamma=gamma,
                              **li)


def _sigma_grad_normal(params, state: MeshFieldState, x: torch.Tensor,
                       cfg: CurvedFieldConfig, rt, mode: str, noise, frames):
    """The field at x with the normal target -grad_x of the remapped
    density (1 - exp(-lambda sigma)) / lambda: (FieldOutput, sigma, geo
    features, normalised -grad [N, 3]).

    The target only ever enters the loss detached (it is the cosine
    loss's target, and the shell mask reads whether it is finite), so
    its own derivative in the params is never needed: one first-order
    ``autograd.grad`` at x, keeping the graph that the training loss
    then backpropagates through sigma -- and through x where x carries
    a gradient (the rays of trainable camera deltas)."""
    with torch.enable_grad():
        xg = x if x.requires_grad else x.detach().requires_grad_(True)
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
    """(sigma [N], color [N, 3], extras).

    Inference (extras {}): noise-free features, the visual and light
    modes as asked, the light turned by ``euler_rot``.  ``training``:
    the features get the probabilistic ``noise`` [N, L * C] (with
    ``prob_model`` and the hash encoder), the colour is the full
    shading of the RGB mode, and with a light model the normals come in
    pairs: extras['normal'] is the fine (predicted) normal, and
    extras['normal_grad'] its target, the -grad(sigma) normal smoothed
    toward the coarse normal by ``smooth_grad_weight`` and detached;
    samples whose -grad(sigma) is not finite leave the shell mask.  The
    UV mode's mask replaces the shell mask."""
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
    normal_rot, coarse_rot, d_eff = normal, normal_coarse, d
    if euler_rot is not None and not training:
        d_eff, normal_rot, coarse_rot = _rotate(euler_rot, d, normal,
                                                normal_coarse)
    if training or visual_mode == "RGB":
        color = _light_or_color(params, geo_feat, normal_rot, coarse_rot,
                                d_eff, cfg,
                                "Full" if training else light_visual_mode,
                                gamma=gamma, light_import=light_import)
    elif visual_mode == "UV":
        color, uv_mask = uv_visual(state, x, cfg,
                                   rt if rt is not None
                                   else FieldRuntime.default(), mode)
        if uv_mask is not None:
            h_mask = uv_mask
    elif visual_mode in ("Tan", "Btan"):
        color = tbn_visual(state, x, cfg, mode,
                           row=0 if visual_mode == "Tan" else 1)
    elif visual_mode == "Grad" and normal_grad is not None:
        color = (normal_grad + 1.0) / 2.0
    elif visual_mode == "Nc":
        color = (normal_coarse + 1.0) / 2.0
    elif visual_mode == "Nf":
        color = (fout.normal_fine + 1.0) / 2.0
    elif visual_mode == "Fea":
        color = torch.clamp((fout.embed[..., :3] + 1.0) / 2.0, 0.0, 1.0)
    else:
        # 'normal', and 'Grad' at inference: the display normal
        color = (normal + 1.0) / 2.0
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
    sigma, (x_embed, phi_embed, z_embed, geo_feat, normal_coarse), h_mask = \
        _baked_embed(params, bake, x, cfg, frames)
    color = _baked_shade(params, x_embed, phi_embed, z_embed, geo_feat,
                         frames["tbn"], normal_coarse, d, cfg, rt,
                         light_visual_mode=light_visual_mode,
                         euler_rot=euler_rot, light_import=light_import)
    return (torch.where(h_mask, sigma, 0.0),
            torch.where(h_mask[..., None], color, 0.0))


def _baked_embed(params, bake, x: torch.Tensor, cfg: CurvedFieldConfig,
                 frames):
    """The per-sample half of ``forward_baked``: (sigma [N], (x_embed,
    phi_embed, z_embed, geo_feat, normal_coarse), h_mask [N]), h_mask
    true inside the shell and the baked tiles."""
    from ..render import baked as baked_mod

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
    return sigma, (x_embed, phi_embed, z_embed, geo_feat,
                   normal_coarse), h_mask


def _baked_shade(params, x_embed, phi_embed, z_embed, geo_feat, tbn,
                 normal_coarse, d, cfg: CurvedFieldConfig,
                 rt: FieldRuntime | None, *, light_visual_mode: str = "Full",
                 euler_rot=None, light_import=None):
    """The shading of ``forward_baked``: the normal net on the baked
    embeddings, the fine / coarse blend, the rotation, the light model or
    colour MLP."""
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
    if euler_rot is not None:
        d, normal, normal_coarse = _rotate(euler_rot, d, normal,
                                           normal_coarse)
    return _light_or_color(params, geo_feat, normal, normal_coarse, d, cfg,
                           light_visual_mode, light_import=light_import)


def forward_baked_s1(params, bake, x: torch.Tensor, cfg: CurvedFieldConfig,
                     frames):
    """Deferred baked stage 1 (a sample): (sigma [N], the flat shading
    feature row [N, F + P + Z + G + 12]) laid out as [x_embed F |
    phi_embed P | z_embed Z | geo_feat G | tbn 9 | normal_coarse 3] and
    split again by ``forward_baked_s2``.  Rows and sigmas outside the
    shell and the baked tiles (``forward_baked``'s h_mask) are zero:
    their composite weight is zero, and zero rows keep the weighted mean
    well-conditioned."""
    sigma, (x_embed, phi_embed, z_embed, geo_feat, normal_coarse), h_mask = \
        _baked_embed(params, bake, x, cfg, frames)
    feat = torch.cat([x_embed, phi_embed, z_embed, geo_feat,
                      frames["tbn"].reshape(-1, 9), normal_coarse], dim=-1)
    return (torch.where(h_mask, sigma, 0.0),
            torch.where(h_mask[:, None], feat, 0.0))


def forward_baked_s2(params, fbar: torch.Tensor, d: torch.Tensor,
                     cfg: CurvedFieldConfig, rt: FieldRuntime | None, *,
                     light_visual_mode: str = "Full", euler_rot=None,
                     light_import=None):
    """Deferred baked stage 2 (a ray): ``forward_baked``'s shading of the
    weight-composited feature row fbar [N, C] (``forward_baked_s1``'s
    layout; the coarse normal renormalised), once a ray instead of once
    a survivor."""
    fcfg = cfg.field
    F = fcfg.encoder_f_out_dim
    P = fcfg.normal_cfg.phi_embed_dim if fcfg.pred_normal else 0
    G = cfg.geo_feat_dim
    Z = fbar.shape[-1] - F - P - G - 12
    x_embed, phi_embed, z_embed, geo_feat, tbn, nc = torch.split(
        fbar, [F, P, Z, G, 9, 3], dim=-1)
    return _baked_shade(params, x_embed, phi_embed, z_embed, geo_feat,
                        tbn.reshape(-1, 3, 3), _normalize(nc), d, cfg, rt,
                        light_visual_mode=light_visual_mode,
                        euler_rot=euler_rot, light_import=light_import)


VISUAL_MODES = ["RGB", "UV", "Grad", "Nc", "Tan", "Btan", "normal", "Fea",
                "Nf"]
LIGHT_VISUAL_MODES = ["Full", "Specular", "Diffuse", "Albedo"]


def regular_loss(params, cfg: CurvedFieldConfig, step=None, *,
                 optimize_camera_loss=None, level: int | None = None,
                 camera_reg_weight=None):
    """The training regularisers: the field's (1e-8 x clustering at
    ``level``), with the Lipschitz normal net under a light model 1e-4 x
    its Lipschitz bound, and the trainer's camera regulariser
    ``optimize_camera_loss`` x 1e4 up to step 2000 and 1e2 after it (the
    reference's schedule), or x ``camera_reg_weight`` where that is
    set."""
    loss = mesh_field.regular_loss(params["field"], cfg.field, level=level)
    if cfg.field.lip and cfg.render_light_model and cfg.field.pred_normal:
        loss = loss + 1e-4 * normal_net.regularization(
            params["field"]["normal"])
    if optimize_camera_loss is not None:
        weight = (camera_reg_weight if camera_reg_weight is not None
                  else (1e2 if step > 2000 else 1e4))
        loss = loss + weight * optimize_camera_loss
    return loss
