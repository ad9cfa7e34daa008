"""Per-scene configuration with presets (port of
``nerf_texture_tpu/config.py``): one dataclass whose properties derive
the port's model, render and training configs, and the registry of the
reference's scenes.  ``field_name`` (the curved config's name)
namespaces the curved checkpoints.
"""

from __future__ import annotations

import dataclasses
import os

from .models.curved_field import CurvedFieldConfig
from .models.mesh_field import MeshFieldConfig
from .models.ngp import NGPConfig
from .render.renderer import RenderConfig
from .train.curved_trainer import CurvedTrainConfig
from .train.trainer import TrainConfig


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Every field of the JAX SceneConfig (a captured scene's defaults:
    SH light, hash encoder of 8 levels, 4096 rays, camera optimisation
    on)."""

    name: str = "scene"
    path: str = "./data/scene"
    workspace: str = "./logs/scene"
    mode: str = "colmap"            # 'colmap' | 'blender'
    surface_type: str = "coacd_remesh"
    coacd_threshold: float = 0.05
    pattern_rate: float = 1 / 50
    bound: float = 1.0
    scale: float = 0.33
    h_threshold: float = 0.1
    light_model: str = "SH"
    num_level: int = 8
    downscale: int = 1
    optimize_camera: bool = True
    optimize_gamma: bool = False
    iters: int = 40000
    num_rays: int = 4096
    lr: float = 1e-2
    encoder_type: str = "hash"      # 'hash' | 'vertex'
    level_num: int = 1
    base_vnum: int = 4096
    target_vnum: int = 128 ** 2
    iters_per_level: int = 0        # 0 = no schedule

    # ---- derived configs --------------------------------------------

    @property
    def ngp(self) -> NGPConfig:
        return NGPConfig(bound=self.bound)

    @property
    def field(self) -> MeshFieldConfig:
        return MeshFieldConfig(num_levels=self.num_level,
                               h_threshold=self.h_threshold,
                               bound=self.bound,
                               pattern_rate=self.pattern_rate,
                               encoder_type=self.encoder_type,
                               level_num=self.level_num,
                               base_vnum=self.base_vnum,
                               target_vnum=self.target_vnum)

    @property
    def curved(self) -> CurvedFieldConfig:
        return CurvedFieldConfig(field=self.field,
                                 light_model=self.light_model,
                                 bound=self.bound)

    @property
    def render(self) -> RenderConfig:
        return RenderConfig.for_bound(self.bound)

    @property
    def train(self) -> TrainConfig:
        return TrainConfig(lr=self.lr, total_steps=self.iters,
                           num_rays=self.num_rays)

    @property
    def curved_train(self) -> CurvedTrainConfig:
        return CurvedTrainConfig(lr=self.lr, total_steps=self.iters,
                                 num_rays=self.num_rays,
                                 optimize_camera=self.optimize_camera,
                                 optimize_gamma=self.optimize_gamma,
                                 iters_per_level=self.iters_per_level)

    @property
    def field_name(self) -> str:
        return self.curved.field_name


# the reference's shipped scenes (its data_args.py and readme)
PRESETS: dict[str, SceneConfig] = {
    "star_flower": SceneConfig(
        name="star_flower", path="./data/star_flower",
        workspace="./logs/star_flower", surface_type="coacd_remesh",
        pattern_rate=1 / 50),
    "durian": SceneConfig(
        name="durian", path="./data/durian",
        workspace="./logs/durian", surface_type="coacd_remesh",
        pattern_rate=1 / 40),
    "wall": SceneConfig(
        name="wall", path="./data/wall", workspace="./logs/wall",
        surface_type="plane", pattern_rate=1 / 50),
    "putian_flower": SceneConfig(
        name="putian_flower", path="./data/putian_flower",
        workspace="./logs/putian_flower", surface_type="coacd_remesh",
        pattern_rate=1 / 50),
    "synthetic_sphere": SceneConfig(
        name="synthetic_sphere", path="<procedural>",
        workspace="./logs/synthetic_sphere", surface_type="sphere",
        iters=4000, optimize_camera=False),
}


def get_preset(name: str, **overrides) -> SceneConfig:
    """The preset ``name``; else, for a scene directory, a SceneConfig
    named after the directory (workspace ./logs/<name>); else one at
    ./data/<name>.  ``overrides`` replace fields."""
    base = PRESETS.get(name)
    if base is None:
        if os.path.isdir(name):
            scene = os.path.basename(os.path.normpath(name)) or "scene"
            base = SceneConfig(name=scene, path=name,
                               workspace=f"./logs/{scene}")
        else:
            base = SceneConfig(name=name, path=f"./data/{name}",
                               workspace=f"./logs/{name}")
    return dataclasses.replace(base, **overrides) if overrides else base
