"""Field export and texture import (port of
``nerf_texture_tpu/train/field_io.py``): ``save_field`` samples texture
patches from a trained curved field into a field npz, ``load_field``
imports a synthesised flat texture (``texture.npz``, see
``synthesis.quilting``) and ``load_patch`` one exported patch, each
followed by the grid refresh of the new mode.

The npz files have the JAX package's schema, so a file written by one
package loads in the other.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP item):
the imports onto another mesh (``load_shape``, ``load_unhash``,
``unhash``; item 11.2) and the mesh, point-cloud and image exports
(``save_mesh``, ``save_point_cloud``, ``take_photo``, ``render_train``,
``render_round``; item 11.5).
"""

from __future__ import annotations

import os

import numpy as np

from ..geometry.mesh import Mesh
from ..geometry.projector import pointcloud_arrays
from ..models import mesh_field
from ..synthesis.patches import PatchSampleConfig, sample_patches


def save_field(trainer, path: str, *, scan_pcl=None, mesh: Mesh = None,
               scfg: PatchSampleConfig | None = None, face_subset=None,
               stats: dict | None = None) -> dict:
    """Sample patches from the trainer's field (its params, not the EMA)
    on the host template ``mesh`` and write the field npz (entries that
    are None are left out).  ``face_subset`` restricts the patch centres
    to those faces; ``stats`` receives the candidate centres and rays
    cast (``sample_patches``).  Returns the export dict."""
    scfg = scfg or PatchSampleConfig()
    out = sample_patches(trainer.state.params["field"], trainer.field_state,
                         trainer.ccfg.field, mesh, scfg, scan_pcl=scan_pcl,
                         face_subset=face_subset, stats=stats)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: v for k, v in out.items() if v is not None})
    return out


def load_field(trainer, path: str):
    """Import a synthesised flat texture (texture.npz: features [H, W, C],
    grid_gap, sample_tbn, sample_tbn_ids, local_tbn, phi_embed) onto the
    z = 0 canvas of half-extents grid_gap * (H, W) / 2, switch the
    trainer to mode 'field' and refresh its grid (``initialize_states``'s
    50 refreshes)."""
    data = np.load(path, allow_pickle=True)
    features = data["features"]
    H, W = features.shape[:2]
    grid_gap = float(data["grid_gap"])
    imported = mesh_field.import_field_data(
        features=features, sample_tbn=data["sample_tbn"],
        sample_tbn_ids=data["sample_tbn_ids"],
        local_tbn=data["local_tbn"].reshape(H, W, 9),
        phi_embed=data["phi_embed"],
        bounds=[0.5 * grid_gap * H, 0.5 * grid_gap * W],
        device=trainer.device)
    trainer.field_state = trainer.field_state._replace(imported=imported)
    trainer.mode = "field"
    trainer.initialize_states()


def load_patch(trainer, field_npz_path: str, patch_id: int = 0):
    """Import patch ``patch_id`` (modulo the count) of a field npz as a
    scattered point field (its hits, with the patch normal), switch the
    trainer to mode 'patch' and refresh its grid (50 refreshes)."""
    data = np.load(field_npz_path, allow_pickle=True)
    pid = patch_id % data["patches"].shape[0]
    coors = data["patch_coors"][pid].reshape(-1, 3)
    norm = data["patch_norms"][pid]
    imported = mesh_field.import_patch_data(
        features=data["patches"][pid].reshape(-1,
                                              data["patches"].shape[-1]),
        local_tbn=data["patch_local_tbn"][pid].reshape(-1, 9),
        phi_embed=data["patch_phi_embed"][pid].reshape(
            -1, data["patch_phi_embed"].shape[-1]),
        device=trainer.device)
    pc = pointcloud_arrays(coors, np.tile(norm[None], (len(coors), 1)),
                           device=trainer.device)
    trainer.field_state = trainer.field_state._replace(
        imported=imported, projector_imported=pc)
    trainer.mode = "patch"
    trainer.initialize_states()


def _not_ported(name: str, item: str, what: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"field_io.{name}: {what} is not ported; ROADMAP Queue 1, item "
            f"{item}")
    fn.__name__ = name
    return fn


load_shape = _not_ported("load_shape", "11.2",
                         "synthesis onto a new target mesh")
load_unhash = _not_ported("load_unhash", "11.2",
                          "the re-bake of a curved_mesh.npz")
unhash = _not_ported("unhash", "11.2",
                     "the bake of the hash field into vertex features")
save_mesh = _not_ported("save_mesh", "11.5", "the isosurface mesh export")
save_point_cloud = _not_ported("save_point_cloud", "11.5",
                               "the scan point-cloud export")
take_photo = _not_ported("take_photo", "11.5", "the offline image export")
render_train = _not_ported("render_train", "11.5",
                           "the offline image export")
render_round = _not_ported("render_round", "11.5",
                           "the offline image export")
