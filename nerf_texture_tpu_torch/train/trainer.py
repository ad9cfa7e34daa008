"""NGP field functions and the serving ``render_frame``.

Port of the inference half of ``nerf_texture_tpu/train/trainer.py``:
the module-level field functions the renderer calls, and
``render_frame``, the counterpart of ``Trainer.render_frame`` for a given
set of parameters and occupancy grid.  The ``Trainer`` class, the train
step and the grid refresh belong to the training port.
"""

from __future__ import annotations

import torch

from ..models import ngp
from ..ops.hashgrid_packed import inference_table
from ..ops.occupancy import OccupancyGrid
from ..render.renderer import PrepassState, RenderConfig, render_image


def _infer_table_dtype(mcfg: ngp.NGPConfig):
    return (torch.bfloat16 if mcfg.encoder == "packed"
            and mcfg.infer_table_bf16 else None)


def ngp_field_apply(params, x, d, mcfg: ngp.NGPConfig):
    """Field fn for rendering: (sigma, rgb) through the inference table."""
    return ngp.forward(params, x, d, mcfg,
                       table_dtype=_infer_table_dtype(mcfg))


def ngp_sigma_apply(params, x, d, mcfg: ngp.NGPConfig):
    """Sigma pass: (sigma, geo_feat), geo_feat kept for the color pass."""
    return ngp.density(params, x, mcfg, table_dtype=_infer_table_dtype(mcfg))


def ngp_color_apply(params, x, d, geo_feat, mcfg: ngp.NGPConfig):
    return ngp.color(params, d, geo_feat, mcfg)


def ngp_infer_params(params, mcfg: ngp.NGPConfig):
    """Params whose table is what inference reads: the bf16 [rows,
    row_width] copy when ``infer_table_bf16``.  Made once per set of
    parameters; params that already carry it are returned as they are."""
    if _infer_table_dtype(mcfg) is None or \
            params["grid"].dtype == torch.bfloat16:
        return params
    return {**params,
            "grid": inference_table(params["grid"], mcfg.packed_spec)}


def render_frame(params, occ: OccupancyGrid | None, pose, intrinsics,
                 H: int, W: int, mcfg: ngp.NGPConfig, rcfg: RenderConfig,
                 *, bg_color=1.0, prepass: PrepassState | None = None,
                 select_cdf=None):
    """Render an H x W novel view of an NGP (``Trainer.render_frame``).

    params: NGP params (``ngp.init`` or converted), ideally passed through
    ``ngp_infer_params`` once; occ: the occupancy grid, from which the
    ``PrepassState`` is built unless ``prepass`` (built once per grid) is
    given.  ``select_cdf``: see ``render_image``.

    Returns dict(image [H, W, 3], depth [H, W], weights_sum [H, W],
    live, chunks)."""
    if mcfg.bg_radius > 0:
        raise NotImplementedError(
            "render_frame: the learned background sphere (bg_radius > 0) is "
            "not ported yet (ROADMAP Queue 1, item 3)")
    if rcfg.deferred:
        raise NotImplementedError(
            "render_frame: deferred shading is not ported (ROADMAP Queue 1, "
            "item 12: port it only if an H100 profile asks for it)")
    if prepass is None:
        prepass = PrepassState.build(occ.occ, rcfg, density=occ.density)
    return render_image(ngp_field_apply, mcfg, ngp_infer_params(params, mcfg),
                        prepass, pose, intrinsics, H, W, rcfg,
                        bg_color=bg_color, select_cdf=select_cdf)
