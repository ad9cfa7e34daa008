"""Data preparation: video -> frames -> masks -> COLMAP -> transforms.json
(port of ``nerf_texture_tpu/data/prepare.py``).

Host code, as in the JAX package: ffmpeg frame extraction, blurry-frame
removal by the variance of the Laplacian, the COLMAP subprocess drivers
and the COLMAP text model -> nerf ``transforms.json`` conversion.  No
image library is needed: frames are read by ``data.images.read_image``
(what ``imageio.v3.imread`` returns), and OpenCV's gray conversion and
Laplacian are computed in integer numpy, so ``laplacian_variance``
equals the JAX function's bit for bit.  External binaries (ffmpeg,
colmap) are optional: each driver raises a ``RuntimeError`` naming the
missing one.  The foreground masks are GrabCut (``ops/grabcut.py``: GMMs
in PyTorch on the device, each cut the max-flow kernel on the card) or,
with ``interactive=True``, the scribble segmenter
(``data/segmenter.py`` served by ``viewer/segment.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess

import numpy as np

import torch

from ..ops.grabcut import GC_INIT_WITH_RECT, foreground, grabcut
from ..ops.imgproc import gray15
from ..ops.kmeans import CvRNG
from .images import read_image, write_png


def extract_frames(video_path: str, out_dir: str, fps: int = 2) -> int:
    """ffmpeg frame extraction: ``out_dir/%04d.png`` at ``fps``; returns
    the number of PNGs in ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not found on PATH")
    subprocess.run(["ffmpeg", "-y", "-i", video_path, "-vf",
                    f"fps={fps}", os.path.join(out_dir, "%04d.png")],
                   check=True)
    return len([f for f in os.listdir(out_dir) if f.endswith(".png")])


def rgb_to_gray(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)`` of uint8 or uint16
    [H, W, 3 or 4] (alpha ignored): OpenCV 5's fixed point, 0.299 R +
    0.587 G + 0.114 B in 15-bit coefficients, rounded, in the input's
    type."""
    if image.ndim != 3 or image.shape[-1] not in (3, 4):
        raise ValueError(f"RGB2GRAY needs 3 or 4 channels, not an array of "
                         f"shape {image.shape}")
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"RGB2GRAY of {image.dtype} is not mirrored "
                         f"(uint8 and uint16 are)")
    x = image.astype(np.int64)
    return gray15(x[..., 0], x[..., 1], x[..., 2]).astype(image.dtype)


def laplacian(gray: np.ndarray) -> np.ndarray:
    """``cv2.Laplacian(gray, cv2.CV_64F)`` of a uint8 or uint16 [H, W]:
    the 4-neighbour kernel (ksize 1) with OpenCV's default border
    (BORDER_REFLECT_101), as float64 (integer-valued, so exact)."""
    if gray.ndim != 2 or gray.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"Laplacian of a {gray.dtype} array of shape "
                         f"{gray.shape} is not mirrored (2-D uint8 or "
                         f"uint16 is)")
    p = np.pad(gray.astype(np.int64), 1, mode="reflect")
    lap = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
           - 4 * p[1:-1, 1:-1])
    return lap.astype(np.float64)


def laplacian_variance(image: np.ndarray) -> float:
    """Sharpness metric: the variance of the Laplacian of the image's
    gray (2-D input is gray already), as the JAX function computes it
    with OpenCV."""
    gray = rgb_to_gray(image) if image.ndim == 3 else image
    return float(laplacian(gray).var())


def remove_blurry_frames(frame_dir: str, keep_ratio: float = 0.8) -> int:
    """Drop the blurriest (1 - keep_ratio) of the frames (PNG / JPEG by
    name); returns how many were removed."""
    files = sorted(f for f in os.listdir(frame_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    scores = []
    for f in files:
        scores.append(laplacian_variance(
            read_image(os.path.join(frame_dir, f))))
    thresh = np.quantile(scores, 1.0 - keep_ratio)
    removed = 0
    for f, s in zip(files, scores):
        if s < thresh:
            os.remove(os.path.join(frame_dir, f))
            removed += 1
    return removed


def segment_foreground(image: np.ndarray, rect=None, iterations: int = 5,
                       *, device="cuda", rng: CvRNG | None = None
                       ) -> np.ndarray:
    """Automatic foreground mask: GrabCut initialised with ``rect`` (the
    central 80% by default) on the image's BGR channels, as the JAX
    function feeds ``cv2.grabCut``.  ``rng`` is the k-means generator
    (advanced in place; a fresh OpenCV thread's state by default).
    Returns a uint8 alpha mask (0 / 255)."""
    h, w = image.shape[:2]
    if rect is None:
        rect = (w // 10, h // 10, w * 8 // 10, h * 8 // 10)
    bgr = torch.from_numpy(np.ascontiguousarray(image[..., :3][..., ::-1]))
    mask, _, _ = grabcut(bgr.to(device), None, rect, None, None, iterations,
                         GC_INIT_WITH_RECT,
                         rng=rng if rng is not None else CvRNG())
    return np.where(foreground(mask).cpu().numpy(), 255, 0).astype(np.uint8)


def apply_masks(frame_dir: str, out_dir: str, *, device="cuda"):
    """Write RGBA frames with GrabCut alpha (``segment_foreground``), the
    frames in name order drawing from one generator in a fresh OpenCV
    thread's state, as the JAX function's calls draw from its thread's."""
    os.makedirs(out_dir, exist_ok=True)
    rng = CvRNG()
    for f in sorted(os.listdir(frame_dir)):
        if not f.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        img = read_image(os.path.join(frame_dir, f))[..., :3]
        alpha = segment_foreground(img, device=device, rng=rng)
        write_png(os.path.join(out_dir, os.path.splitext(f)[0] + ".png"),
                  np.concatenate([img, alpha[..., None]], -1))


def run_colmap(image_dir: str, workspace: str,
               matcher: str = "sequential") -> str:
    """COLMAP feature extraction, matching, mapping and the text model
    export; returns the text model's directory."""
    if shutil.which("colmap") is None:
        raise RuntimeError("colmap not found on PATH")
    db = os.path.join(workspace, "colmap.db")
    sparse = os.path.join(workspace, "sparse")
    text = os.path.join(workspace, "colmap_text")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(text, exist_ok=True)

    def run(*cmd):
        subprocess.run(list(cmd), check=True)

    run("colmap", "feature_extractor", "--database_path", db,
        "--image_path", image_dir, "--ImageReader.camera_model",
        "OPENCV", "--ImageReader.single_camera", "1")
    run("colmap", f"{matcher}_matcher", "--database_path", db)
    run("colmap", "mapper", "--database_path", db, "--image_path",
        image_dir, "--output_path", sparse)
    run("colmap", "model_converter", "--input_path",
        os.path.join(sparse, "0"), "--output_path", text,
        "--output_type", "TXT")
    return text


def _qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])


def colmap_to_transforms(text_dir: str, image_dir: str, out_path: str,
                         aabb_scale: int = 4) -> dict:
    """COLMAP text model -> transforms.json, written to ``out_path`` and
    returned.

    The first camera line gives the intrinsics: SIMPLE_PINHOLE and
    SIMPLE_RADIAL read (f, cx, cy), every other model (fx, fy, cx, cy)
    from its first four parameters (so RADIAL and the other one-focal
    models read cx as fy, as the JAX parser reads them); distortion is
    ignored.  Poses: COLMAP world2cam -> cam2world with the nerf/blender
    axis flips; ``NeRFDataset`` then applies ``nerf_matrix_to_ngp``.
    """
    with open(os.path.join(text_dir, "cameras.txt")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            w, h = float(parts[2]), float(parts[3])
            fl_x = float(parts[4])
            model = parts[1]
            simple = model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL")
            fl_y = fl_x if simple else float(parts[5])
            cx = float(parts[5 if simple else 6])
            cy = float(parts[6 if simple else 7])
            break

    frames = []
    with open(os.path.join(text_dir, "images.txt")) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    for ln in lines[::2]:   # every other line is the 2D-points list
        parts = ln.split()
        if len(parts) < 10:
            continue
        q = np.array([float(v) for v in parts[1:5]])
        t = np.array([float(v) for v in parts[5:8]])
        name = parts[9]
        w2c = np.eye(4)
        w2c[:3, :3] = _qvec2rotmat(q)
        w2c[:3, 3] = t
        c2w = np.linalg.inv(w2c)
        # colmap camera (x right, y down, z forward) -> nerf convention
        # (x right, y up, z back): flip the y and z columns
        c2w[0:3, 1] *= -1
        c2w[0:3, 2] *= -1
        frames.append({
            "file_path": os.path.join(os.path.basename(image_dir), name),
            "transform_matrix": c2w.tolist(),
        })

    out = {
        "fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy,
        "w": int(w), "h": int(h), "aabb_scale": aabb_scale,
        "frames": frames,
    }
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    return out


def prepare_scene(video_path: str, scene_dir: str, *, fps: int = 2,
                  keep_ratio: float = 0.8, mask: bool = True,
                  interactive: bool = False, port: int = 7870,
                  device="cuda"):
    """The capture pipeline: frames from the video, the blurry ones
    removed, masks, COLMAP on the (masked) frames, then
    ``scene_dir/transforms.json`` (returned).

    ``interactive=True`` serves the browser scribble segmenter on ``port``
    and blocks until Ctrl-C; if the user saved masks (``images_masked/``)
    COLMAP runs on them.  ``mask=True`` without ``interactive`` writes
    GrabCut-masked RGBA frames to ``images/``.  GrabCut runs on
    ``device``."""
    frames_dir = os.path.join(scene_dir, "images_raw")
    extract_frames(video_path, frames_dir, fps=fps)
    remove_blurry_frames(frames_dir, keep_ratio=keep_ratio)
    image_dir = frames_dir
    if interactive:
        from ..viewer.segment import serve_segmenter
        from .segmenter import MaskSession

        session = MaskSession(frames_dir, device=device)
        print("[prepare] scribble the object, then 'save masks' and "
              "Ctrl-C to continue")
        try:
            serve_segmenter(session, port=port)
        except KeyboardInterrupt:
            pass
        masked = os.path.join(scene_dir, "images_masked")
        if os.path.isdir(masked) and os.listdir(masked):
            image_dir = masked
    elif mask:
        image_dir = os.path.join(scene_dir, "images")
        apply_masks(frames_dir, image_dir, device=device)
    text_dir = run_colmap(image_dir, scene_dir)
    return colmap_to_transforms(text_dir, image_dir,
                                os.path.join(scene_dir, "transforms.json"))
