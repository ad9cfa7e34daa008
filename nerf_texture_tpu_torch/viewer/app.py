"""Interactive viewer application (port of ``nerf_texture_tpu/viewer/app.py``).

``ViewerApp`` is the engine of the viewer: the per-frame train / render
loop with the frame-time controllers, the orbit camera, and every viewer
action as a method (the field, patch, shape, unhash and envmap imports
and exports, the visual and light modes, the sliders, the offline
renders).  ``serve`` (server.py) exposes it as an MJPEG stream and JSON
control endpoints.  It drives an NGP ``Trainer`` or a ``CurvedTrainer``
of the port, on the trainer's device.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch

from ..train import field_io
from .camera import OrbitCamera
from .controllers import (FrameTimer, ResolutionController,
                          TrainStepController)


class ViewerApp:
    def __init__(self, trainer, *, W: int = 800, H: int = 800,
                 train_target_ms: float = 500.0,
                 render_target_ms: float = 200.0):
        self.trainer = trainer
        self.camera = OrbitCamera(W, H, radius=getattr(
            trainer.dataset, "radius", 2.0))
        self.train_ctrl = TrainStepController(train_target_ms)
        self.res_ctrl = ResolutionController(render_target_ms)
        self.training = False
        self.bg_color = 1.0
        self.euler = np.zeros(3)
        self.last_metrics = {}
        # frames rendered, and the live rays and chunks of the last one
        self.frames = 0
        self.last_frame = {"live": 0, "chunks": 0}

    # ---- per-frame loop ----------------------------------------------------

    def frame(self) -> np.ndarray:
        """Train ``train_ctrl.steps`` steps while ``training``, then render
        the camera's view; both controllers see the times."""
        if self.training:
            with FrameTimer() as t:
                m = self.trainer.train(self.train_ctrl.steps)
            self.last_metrics = {k: float(v) for k, v in m.items()
                                 if not isinstance(v, (list, tuple))}
            self.last_metrics["step"] = float(self.trainer.state.step)
            self.train_ctrl.update(t.ms)
        with FrameTimer() as t:
            img = self.render()
        self.res_ctrl.update(t.ms)
        return img

    def render(self) -> np.ndarray:
        """The camera's view at the controller's downscale, repeated up to
        [H, W, 3] uint8."""
        ds = self.res_ctrl.downscale
        H = max(self.camera.H // ds, 32)
        W = max(self.camera.W // ds, 32)
        kw = {}
        if (getattr(self, "baked", False) and not self.training
                and hasattr(self.trainer, "bake_atlas")):
            # the baked atlas (render/baked.py) only while not training:
            # it bakes again after every parameter change
            kw["baked"] = True
        out = self.trainer.render_frame(self.camera.pose, H=H, W=W,
                                        bg_color=self.bg_color, **kw)
        self.frames += 1
        self.last_frame = {"live": out["live"], "chunks": out["chunks"]}
        img = np.clip(out["image"].cpu().numpy(), 0, 1)
        if ds > 1:
            img = np.repeat(np.repeat(img, ds, 0), ds, 1)
        return (img[:self.camera.H, :self.camera.W] * 255).astype(
            np.uint8)

    # ---- actions -------------------------------------------------------------

    def start_training(self):
        self.training = True

    def stop_training(self):
        self.training = False

    def toggle_baked(self):
        """Render through the baked atlas while not training (it bakes on
        first use)."""
        self.baked = not getattr(self, "baked", False)
        return self.baked

    def switch_visual_mode(self, mode: str | None = None):
        from ..models.curved_field import VISUAL_MODES

        modes = VISUAL_MODES
        cur = getattr(self.trainer, "visual_mode", "RGB")
        if mode is None:
            mode = modes[(modes.index(cur) + 1) % len(modes)]
        self.trainer.visual_mode = mode
        return mode

    def switch_light_mode(self, mode: str | None = None):
        from ..models.curved_field import LIGHT_VISUAL_MODES

        modes = LIGHT_VISUAL_MODES
        cur = getattr(self.trainer, "light_visual_mode", "Full")
        if mode is None:
            mode = modes[(modes.index(cur) + 1) % len(modes)]
        self.trainer.light_visual_mode = mode
        return mode

    def set_euler(self, x: float, y: float, z: float):
        """The light's rotation vector, which every render path applies."""
        self.euler = np.array([x, y, z], np.float32)
        self.trainer.euler = self.euler

    # the sliders of the field's runtime scalars (FieldRuntime holds
    # floats: an eager render reads them anew every frame)
    def set_sdf_factor(self, v: float):
        self.trainer.runtime = self.trainer.runtime._replace(
            sdf_scale_factor=float(v))

    def set_sdf_offset(self, v: float):
        self.trainer.runtime = self.trainer.runtime._replace(
            sdf_offset=float(v))

    def set_uv_rate(self, v: float):
        self.trainer.runtime = self.trainer.runtime._replace(
            uv_utilize_rate=float(v))

    def set_fc_weight(self, v: float):
        """The fine / coarse normal blend."""
        self.trainer.runtime = self.trainer.runtime._replace(
            fc_weight=float(v))

    def set_aabb(self, dim: int, v: float):
        """One face of the inference crop [6] (xmin, ymin, zmin, xmax,
        ymax, zmax), which render_frame intersects with the occupied
        AABB."""
        crop = getattr(self.trainer, "crop_aabb", None)
        if crop is None:
            b = self.trainer.rcfg.bound
            crop = np.array([-b, -b, -b, b, b, b], np.float32)
        crop = np.asarray(crop, np.float32).copy()
        crop[int(dim)] = float(v)
        self.trainer.crop_aabb = crop

    def set_h_threshold(self, v: float):
        fcfg = dataclasses.replace(self.trainer.ccfg.field,
                                   h_threshold=float(v))
        self.trainer.ccfg = dataclasses.replace(self.trainer.ccfg,
                                                field=fcfg)
        self.trainer.initialize_states(10)

    # imports and exports (field_io); a mesh argument may be an .obj path,
    # so that every action can be driven through the JSON /control endpoint
    def save_field(self, path, mesh=None, scan_pcl=None, scfg=None):
        mesh = self._resolve_mesh(mesh)
        return field_io.save_field(self.trainer, path, mesh=mesh,
                                   scan_pcl=scan_pcl, scfg=scfg)

    def load_field(self, path):
        field_io.load_field(self.trainer, path)

    def load_patch(self, path, patch_id=0):
        field_io.load_patch(self.trainer, path, patch_id)

    def load_shape(self, mesh):
        return field_io.load_shape(self.trainer, self._resolve_mesh(mesh))

    def _resolve_mesh(self, mesh):
        """None -> the trainer's template mesh; str -> load_obj(path)."""
        if mesh is None:
            mesh = getattr(self.trainer, "template_mesh", None)
            if mesh is None:
                raise ValueError("no mesh given and trainer has no "
                                 "template_mesh")
            return mesh
        if isinstance(mesh, str):
            from ..geometry.mesh import load_obj
            return load_obj(mesh)
        return mesh

    def load_unhash(self, path):
        return field_io.load_unhash(self.trainer, path)

    def bake_unhash(self, min_vertices: int = 100000):
        """Bake the trained field into per-vertex features."""
        return field_io.unhash(self.trainer, min_vertices=min_vertices)

    def switch_import(self, mode: str | None = None):
        """Toggle between the trained field ('none') and the last imported
        source; with an argument, set it.  Refreshes the density grid for
        the source now active."""
        tr = self.trainer
        cur = getattr(tr, "mode", "none")
        last = getattr(tr, "_last_import_mode", None)
        if mode is None:
            if cur == "none" and last is None:
                warnings.warn("switch_import: nothing imported yet")
                return cur
            mode = last if cur == "none" else "none"
        if cur != "none":
            tr._last_import_mode = cur
        tr.mode = mode
        tr.initialize_states(10)
        return mode

    def pick_region(self, x0: float, y0: float, x1: float, y1: float):
        """Select the template mesh's faces whose centroids project into
        the pixel rectangle [x0, x1] x [y0, y1] of the current view and
        face the camera; save_field's patches keep to them.  Returns the
        number of faces picked (0, with a warning, without a template
        mesh)."""
        mesh = getattr(self.trainer, "template_mesh", None)
        if mesh is None:
            warnings.warn("pick_region needs trainer.template_mesh")
            return 0
        verts = np.asarray(mesh.vertices)
        faces = np.asarray(mesh.faces)
        tri = verts[faces]                       # [F, 3, 3]
        cent = tri.mean(1)
        fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        pose = self.camera.pose
        cam = (cent - pose[:3, 3]) @ pose[:3, :3]
        z = np.maximum(cam[:, 2], 1e-6)
        fx, fy, cx, cy = self.camera.intrinsics
        u = fx * cam[:, 0] / z + cx
        v = fy * cam[:, 1] / z + cy
        facing = np.sum(fn * (cent - pose[:3, 3]), -1) < 0
        keep = ((cam[:, 2] > 0) & facing
                & (u >= min(x0, x1)) & (u <= max(x0, x1))
                & (v >= min(y0, y1)) & (v <= max(y0, y1)))
        picked = np.where(keep)[0].astype(np.int32)
        self.trainer.picked_faces = picked if picked.size else None
        return int(picked.size)

    def clear_picked_region(self):
        self.trainer.picked_faces = None

    def load_envmap(self, path, with_visibility: bool = True):
        """Import an environment map for relighting."""
        return self.trainer.load_envmap(path,
                                        with_visibility=with_visibility)

    def clear_envmap(self):
        self.trainer.clear_envmap()

    def save_checkpoint(self, path):
        self.trainer.save_checkpoint(path)

    def load_checkpoint(self, path):
        self.trainer.load_checkpoint(path)

    # ---- offline renders and exports -------------------------------------

    def take_photo(self, path, H=None, W=None):
        """The camera's view at H x W (default the trainer's), written as a
        PNG."""
        return field_io.take_photo(self.trainer, self.camera.pose,
                                   H=H, W=W, path=path)

    def render_train(self, out_dir, indices=None):
        """Every training pose re-rendered."""
        return field_io.render_train(self.trainer, out_dir,
                                     indices=indices)

    def render_round(self, out_dir, n_frames: int = 30):
        """An orbit turntable."""
        return field_io.render_round(self.trainer, out_dir,
                                     n_frames=n_frames)

    def save_point_cloud(self, path):
        """A scan point cloud from depth back-projection."""
        return field_io.save_point_cloud(self.trainer, path)

    def save_mesh(self, path, resolution: int = 256):
        """The marching-cubes mesh of the current density."""
        tr = self.trainer
        if hasattr(tr, "ccfg"):
            from ..models import curved_field

            @torch.no_grad()
            def density_fn(pts):
                return curved_field.density(
                    tr.state.params, tr.field_state, pts, tr.ccfg,
                    tr.runtime, mode=tr.mode)[0]
        else:
            from ..models import ngp

            @torch.no_grad()
            def density_fn(pts):
                return ngp.density(tr.state.params, pts, tr.mcfg)[0]
        return field_io.save_mesh(density_fn, path, resolution=resolution,
                                  bound=tr.rcfg.bound, device=tr.device)

    def save_envmap(self, path, H: int = 128):
        """The current environment light (learned or imported) as an
        equirect image [H, 2H] at lat-long directions, clipped to [0, 1];
        written as a PNG, or a JPEG for a .jpg / .jpeg path."""
        tr = self.trainer
        th = (np.arange(H) + 0.5) / H * np.pi
        ph = (np.arange(2 * H) + 0.5) / (2 * H) * 2 * np.pi - np.pi
        T, P = np.meshgrid(th, ph, indexing="ij")
        dirs = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                         np.cos(T)], -1).reshape(-1, 3)
        li = getattr(tr, "light_import", None) or {}
        model = getattr(tr.ccfg, "light_model", "SH")
        params = tr.state.params.get("light", {})
        probe, imp = {"SH": ("env_shs", "env_import"),
                      "SG": ("lgt_sgs", "lgt_sgs_import"),
                      "Envmap": ("env_probes", "env_import")
                      }.get(model, ("env_shs", "env_import"))
        if li.get(imp) is None and params.get(probe) is None:
            raise ValueError(
                "no environment light to export: the model was built with "
                f"light_model={model!r} but carries no light parameters "
                "(render_light_model off?) and no imported envmap")

        def host(x):
            return (x.detach().cpu().numpy() if torch.is_tensor(x)
                    else np.asarray(x))

        if model == "SH":
            from ..models.lights import sh as shl
            coeffs = li.get("env_import", params.get("env_shs"))
            n = int(np.sqrt(host(coeffs).shape[0]))
            img = host(shl.sh_eval_color(
                torch.as_tensor(coeffs), torch.as_tensor(
                    dirs, dtype=torch.float32, device=torch.as_tensor(
                        coeffs).device), n))
        elif model == "SG":
            lob = host(li.get("lgt_sgs_import", params.get("lgt_sgs")))
            axis = lob[:, :3] / (np.linalg.norm(lob[:, :3], axis=-1,
                                                keepdims=True) + 1e-8)
            lam, mu = np.abs(lob[:, 3:4]), np.abs(lob[:, 4:7])
            cos = dirs @ axis.T                          # [N, S]
            img = np.exp((cos - 1.0) * lam[:, 0][None]) @ mu
        else:
            env = host(li.get("env_import", params.get("env_probes")))
            iy = (np.arange(H) * env.shape[0] // H)
            ix = (np.arange(2 * H) * env.shape[1] // (2 * H))
            img = env[iy][:, ix].reshape(-1, env.shape[-1])
        img = np.clip(img.reshape(H, 2 * H, -1), 0.0, 1.0)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, -1)
        u8 = (img * 255).astype(np.uint8)
        if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg"):
            from ..data.jpeg import write_jpeg
            write_jpeg(path, u8)
        else:
            from ..data.images import write_png
            write_png(path, u8)
        return path

    # ---- toggles -----------------------------------------------------------

    def set_bg(self, v):
        """Background brightness."""
        self.bg_color = float(v)

    def set_fovy(self, v: float):
        self.camera.fovy = float(v)

    def set_dt_gamma(self, v: float):
        """The march's growing step (the pool path's; 0: constant)."""
        self.trainer.rcfg = dataclasses.replace(self.trainer.rcfg,
                                                dt_gamma=float(v))

    def set_k_for_uv(self, k: int):
        fcfg = dataclasses.replace(self.trainer.ccfg.field,
                                   k_for_uv=int(k))
        self.trainer.ccfg = dataclasses.replace(self.trainer.ccfg,
                                                field=fcfg)

    def toggle_shade_visibility(self):
        """The SH light's visibility probes on / off."""
        c = self.trainer.ccfg
        self.trainer.ccfg = dataclasses.replace(
            c, no_visibility=not c.no_visibility)
        return not self.trainer.ccfg.no_visibility

    def toggle_distillation(self):
        """Distillation on / off (it needs a loaded teacher)."""
        t = self.trainer.tcfg
        self.trainer.tcfg = dataclasses.replace(
            t, distillation=not t.distillation)
        return self.trainer.tcfg.distillation

    def reset_camera(self):
        self.camera = OrbitCamera(self.camera.W, self.camera.H,
                                  radius=getattr(self.trainer.dataset,
                                                 "radius", 2.0))

    def set_dynamic_resolution(self, on: bool = True, tier: int = 3):
        """Freeze the downscale tier (3: full resolution), or let the
        controller tune it again."""
        self.res_ctrl.enabled = bool(on)
        if not on:
            self.res_ctrl.tier = int(tier)
