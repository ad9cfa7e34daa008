"""Captured scenes: ``transforms*.json`` loading (port of
``nerf_texture_tpu/data/provider.py``).

Host numpy, as in the JAX package: the images load once as uint8, the
poses go to the ngp convention and are normalised, and the trainers copy
the arrays to the device.  Images are read by ``data.images`` (PNG and
baseline JPEG without an image library) and resized with PIL's Lanczos
arithmetic, so the arrays equal the JAX loader's bit for bit.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from .images import load_image, resize
from .poses import nerf_matrix_to_ngp, normalize_cps


class NeRFDataset:
    """Loads colmap/blender ``transforms*.json`` scenes.

    Attributes:
      poses: [B, 4, 4] float32 c2w (ngp convention, normalized).
      images: [B, H, W, C] uint8 (C = 3 or 4).
      intrinsics: [4] (fx, fy, cx, cy).
      radius: the mean distance of the cameras from the origin.

    mode 'colmap' reads ``transforms.json``; its split 'train' drops the
    first frame and 'val' keeps only it.  mode 'blender' reads
    ``transforms_<split>.json``, or with split 'all' every ``*.json`` of
    the directory, in name order.
    """

    def __init__(self, root_path: str, *, mode: str = "colmap",
                 split: str = "train", downscale: int = 1,
                 scale: float = 0.33, normalize: bool = True,
                 max_data_num: int | None = None):
        self.root_path = root_path
        self.mode = mode
        self.split = split
        transform = self._load_transform(mode, split)

        self.H = int(transform["h"]) // downscale if "h" in transform else None
        self.W = int(transform["w"]) // downscale if "w" in transform else None

        frames = transform["frames"]
        if mode == "colmap" and split == "train":
            frames = frames[1:]
        elif mode == "colmap" and split == "val":
            frames = frames[:1]

        poses, images = [], []
        for f in frames:
            f_path = os.path.join(root_path, f["file_path"])
            if mode == "blender" or os.path.splitext(f_path)[1] not in (
                    ".png", ".jpg", ".jpeg"):
                f_path += ".png"
            if not os.path.exists(f_path):
                continue
            pose = nerf_matrix_to_ngp(
                np.array(f["transform_matrix"], dtype=np.float32),
                scale=scale)
            img = load_image(f_path)
            if self.H is None:
                self.H, self.W = (img.shape[0] // downscale,
                                  img.shape[1] // downscale)
            if img.shape[:2] != (self.H, self.W):
                img = resize(img, self.W, self.H)
            poses.append(pose)
            images.append(img)

        self.poses = np.stack(poses, axis=0)
        if normalize:
            self.poses, _ = normalize_cps(self.poses, scale=1.2)
        if max_data_num is not None:
            self.poses = self.poses[:max_data_num]
            images = images[:max_data_num]
        self.images = np.stack(images, axis=0)
        self.radius = float(
            np.linalg.norm(self.poses[:, :3, 3], axis=-1).mean())
        self.intrinsics = load_intrinsics(transform, self.H, self.W,
                                          downscale)

    def _load_transform(self, mode, split):
        if mode == "colmap":
            with open(os.path.join(self.root_path, "transforms.json")) as f:
                return json.load(f)
        if mode == "blender":
            if split == "all":
                transform = None
                for p in sorted(glob.glob(
                        os.path.join(self.root_path, "*.json"))):
                    with open(p) as f:
                        t = json.load(f)
                    if transform is None:
                        transform = t
                    else:
                        transform["frames"].extend(t["frames"])
                return transform
            with open(os.path.join(self.root_path,
                                   f"transforms_{split}.json")) as f:
                return json.load(f)
        raise ValueError(f"unknown dataset mode: {mode}")

    @property
    def num_frames(self) -> int:
        return self.poses.shape[0]


def load_intrinsics(transform, H, W, downscale):
    """(fx, fy, cx, cy) float32 from ``fl_x`` / ``fl_y`` or
    ``camera_angle_x`` / ``camera_angle_y`` (one stands in for the other)
    and ``cx`` / ``cy`` (default the image centre), at the downscaled
    size."""
    if "fl_x" in transform or "fl_y" in transform:
        fl_x = transform.get("fl_x", transform.get("fl_y")) / downscale
        fl_y = transform.get("fl_y", transform.get("fl_x")) / downscale
    elif "camera_angle_x" in transform or "camera_angle_y" in transform:
        fl_x = fl_y = None
        if "camera_angle_x" in transform:
            fl_x = W / (2 * np.tan(transform["camera_angle_x"] / 2))
        if "camera_angle_y" in transform:
            fl_y = H / (2 * np.tan(transform["camera_angle_y"] / 2))
        fl_x = fl_x if fl_x is not None else fl_y
        fl_y = fl_y if fl_y is not None else fl_x
    else:
        raise RuntimeError("transforms.json has no focal length")
    cx = transform.get("cx", W / 2) / (downscale if "cx" in transform else 1)
    cy = transform.get("cy", H / 2) / (downscale if "cy" in transform else 1)
    return np.array([fl_x, fl_y, cx, cy], dtype=np.float32)
