"""Interactive video segmentation: scribbles -> GrabCut -> propagation
(port of ``nerf_texture_tpu/data/segmenter.py``).

The workflow of the JAX package's ``MaskSession``: the user scribbles
foreground / background strokes on a keyframe (served by
``viewer/segment.py``), GrabCut turns strokes and a prior into a mask,
the mask propagates to neighbouring frames by Farneback optical flow,
each refined by another GrabCut pass seeded from the warped mask, and
``save`` writes ``masks/`` and the RGBA composites that the COLMAP stage
reads.  The JAX package runs all of it in OpenCV on the host; here the
image operations, Farneback and GrabCut's GMMs run in PyTorch on the
session's device (``ops/imgproc.py``, ``ops/optflow.py``,
``ops/grabcut.py``), and each cut is the hand-written max-flow kernel on
the card (``ops/maxflow.py``).  Frames are read by
``data.images.read_image`` and files written by ``write_png``: no image
library is needed.

GrabCut's k-means draws from ``self.rng``, a mirror of OpenCV's thread
RNG that the session advances call by call: a session made with
``seed=s`` runs in step with the JAX session after ``cv2.setRNGSeed(s)``
(the default, 0xFFFFFFFF, is a fresh OpenCV thread's state).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ops import draw, imgproc
from ..ops.grabcut import (GC_BGD, GC_FGD, GC_INIT_WITH_MASK, GC_PR_BGD,
                           GC_PR_FGD, foreground, grabcut)
from ..ops.kmeans import CvRNG
from ..ops.optflow import farneback
from .images import read_image, write_png


class MaskSession:
    """One segmentation session over an ordered frame directory.

    ``timings`` sums the seconds of each stage over the session's calls
    (the device synchronised at each boundary): "resize", "flow",
    "kmeans" (GrabCut's initialisation; its centre sums on the host),
    "gmm" (N-links, assignment, learning, T-links) and "cut"."""

    def __init__(self, frame_dir: str, max_side: int = 960,
                 device="cuda", seed: int = 0xFFFFFFFF):
        self.frame_dir = frame_dir
        self.files = sorted(
            f for f in os.listdir(frame_dir)
            if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if not self.files:
            raise ValueError(f"no frames in {frame_dir}")
        self.device = torch.device(device)
        self.rng = CvRNG(seed)
        self.timings: dict[str, float] = {}
        first = self.load_frame(0)
        self.H, self.W = first.shape[:2]
        scale = max(self.H, self.W) / max_side
        self.work_scale = max(1.0, scale)    # GrabCut / flow resolution
        n = len(self.files)
        # per-frame scribbles: 0 = none, 1 = foreground, 2 = background
        self.strokes = [np.zeros((self.H, self.W), np.uint8)
                        for _ in range(n)]
        self.masks: list[np.ndarray | None] = [None] * n

    # -- frame / stroke IO ------------------------------------------------

    def load_frame(self, idx: int) -> np.ndarray:
        img = read_image(os.path.join(self.frame_dir, self.files[idx]))
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        return np.ascontiguousarray(img[..., :3])

    def add_stroke(self, idx: int, points, label: int,
                   radius: int = 6) -> None:
        """Rasterize a polyline scribble; label 1=fg, 2=bg."""
        pts = np.asarray(points, np.int32).reshape(-1, 2)
        draw.polyline(self.strokes[idx], pts, int(label), 2 * radius)
        if len(pts) == 1:
            draw.circle(self.strokes[idx], pts[0], radius, int(label))

    def clear_strokes(self, idx: int) -> None:
        self.strokes[idx][:] = 0

    # -- segmentation -----------------------------------------------------

    def _lap(self, key: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.timings[key] = self.timings.get(key, 0.0) + t - t0
        return t

    def _work_size(self) -> tuple[int, int]:
        s = self.work_scale
        return int(round(self.W / s)), int(round(self.H / s))

    def _grabcut(self, img: np.ndarray, seed: np.ndarray,
                 iters: int = 5) -> np.ndarray:
        """seed: GrabCut label map (GC_BGD/FGD/PR_BGD/PR_FGD)."""
        t0 = time.perf_counter()
        dev = self.device
        img_t = torch.from_numpy(img).to(dev)
        seed_t = torch.from_numpy(np.ascontiguousarray(seed)).to(dev)
        if self.work_scale > 1.0:
            size = self._work_size()
            img_w = imgproc.resize_area(img_t, size)
            seed_w = imgproc.resize_nearest(seed_t, size)
        else:
            img_w, seed_w = img_t, seed_t.clone()
        t0 = self._lap("resize", t0)
        if not bool(((seed_w == GC_FGD) | (seed_w == GC_PR_FGD)).any()):
            return np.zeros(img.shape[:2], bool)
        if not bool(((seed_w == GC_BGD) | (seed_w == GC_PR_BGD)).any()):
            seed_w[0, :] = seed_w[-1, :] = GC_BGD
            seed_w[:, 0] = seed_w[:, -1] = GC_BGD
        mask, _, _ = grabcut(img_w, seed_w, None, None, None, iters,
                             GC_INIT_WITH_MASK, rng=self.rng,
                             timings=self.timings)
        t0 = time.perf_counter()
        m = foreground(mask)
        if self.work_scale > 1.0:
            m = imgproc.resize_nearest(m.to(torch.uint8),
                                       (img.shape[1], img.shape[0])) > 0
        m = m.cpu().numpy()
        self._lap("resize", t0)
        return m

    def segment(self, idx: int) -> np.ndarray:
        """GrabCut from this frame's scribbles (+ previous mask prior)."""
        seed = np.full((self.H, self.W), GC_PR_BGD, np.uint8)
        prior = self.masks[idx]
        if prior is not None:
            seed[prior] = GC_PR_FGD
        else:
            # no prior: a generous probable-foreground box around the fg
            # strokes (the classic rect init), carved back by the
            # background model and the bg strokes
            ys, xs = np.nonzero(self.strokes[idx] == 1)
            if len(ys):
                ex = int(1.5 * max(int(np.ptp(xs)), int(np.ptp(ys)), 10))
                seed[max(0, ys.min() - ex):ys.max() + ex,
                     max(0, xs.min() - ex):xs.max() + ex] = GC_PR_FGD
        seed[self.strokes[idx] == 1] = GC_FGD
        seed[self.strokes[idx] == 2] = GC_BGD
        mask = self._grabcut(self.load_frame(idx), seed)
        self.masks[idx] = mask
        return mask

    def propagate(self, src: int, dst: int) -> np.ndarray:
        """Warp src's mask to dst by dense optical flow, refine with a
        GrabCut pass seeded from the warped mask (eroded core = sure
        foreground, dilated ring = uncertain)."""
        if self.masks[src] is None:
            raise ValueError(f"frame {src} has no mask to propagate")
        dev = self.device
        t0 = time.perf_counter()
        size = self._work_size()
        g0 = imgproc.rgb_to_gray(imgproc.resize_linear(
            torch.from_numpy(self.load_frame(src)).to(dev), size))
        g1 = imgproc.rgb_to_gray(imgproc.resize_linear(
            torch.from_numpy(self.load_frame(dst)).to(dev), size))
        t0 = self._lap("resize", t0)
        flow = farneback(g1, g0)                        # dst -> src
        t0 = self._lap("flow", t0)
        h, w = size[1], size[0]
        yy, xx = torch.meshgrid(
            torch.arange(h, device=dev, dtype=torch.float32),
            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
        m_small = imgproc.resize_nearest(torch.from_numpy(
            self.masks[src].astype(np.uint8)).to(dev), size)
        warped = imgproc.remap_nearest(m_small, xx + flow[..., 0],
                                       yy + flow[..., 1]) > 0
        core = imgproc.erode(warped.to(torch.uint8), 5, 2) > 0
        ring = imgproc.dilate(warped.to(torch.uint8), 5, 3) > 0
        seed_small = torch.full(warped.shape, GC_BGD, dtype=torch.uint8,
                                device=dev)
        seed_small[ring] = GC_PR_BGD
        seed_small[warped] = GC_PR_FGD
        seed_small[core] = GC_FGD
        seed = imgproc.resize_nearest(seed_small,
                                      (self.W, self.H)).cpu().numpy()
        self._lap("resize", t0)
        # dst scribbles (if any) override the propagated prior
        seed[self.strokes[dst] == 1] = GC_FGD
        seed[self.strokes[dst] == 2] = GC_BGD
        mask = self._grabcut(self.load_frame(dst), seed)
        self.masks[dst] = mask
        return mask

    def propagate_all(self, src: int) -> int:
        """Propagate outward (src -> both ends); returns frames masked."""
        n = 0
        for i in range(src + 1, len(self.files)):
            self.propagate(i - 1, i)
            n += 1
        for i in range(src - 1, -1, -1):
            self.propagate(i + 1, i)
            n += 1
        return n

    # -- output -----------------------------------------------------------

    def save(self, out_dir: str, composite_dir: str | None = None) -> int:
        """Write masks/<frame>.png (gray, 0/255) and optionally the RGBA
        composites the COLMAP stage consumes; returns the frames
        written."""
        os.makedirs(out_dir, exist_ok=True)
        if composite_dir:
            os.makedirs(composite_dir, exist_ok=True)
        n = 0
        for i, f in enumerate(self.files):
            if self.masks[i] is None:
                continue
            m = (self.masks[i] * 255).astype(np.uint8)
            name = os.path.splitext(f)[0] + ".png"
            write_png(os.path.join(out_dir, name), m)
            if composite_dir:
                write_png(os.path.join(composite_dir, name),
                          np.dstack([self.load_frame(i), m]))
            n += 1
        return n
