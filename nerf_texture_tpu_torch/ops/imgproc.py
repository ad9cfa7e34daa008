"""OpenCV's integer image operations that the segmenter uses, in PyTorch on
the session's device, bit for bit with ``cv2``:

- ``resize_nearest``: ``cv2.resize(..., INTER_NEAREST)``, source index
  floor(dst * (1 / (dsize / ssize))) clamped (not INTER_NEAREST_EXACT);
- ``resize_area``: ``cv2.resize(..., INTER_AREA)`` of uint8 when shrinking:
  the block mean at an integer scale, OpenCV's area weights otherwise;
- ``resize_linear``: ``cv2.resize`` (INTER_LINEAR) of uint8 when shrinking,
  in OpenCV's fixed point (11-bit coefficients); at scale 2 OpenCV takes the area path,
  which is the same function;
- ``remap_nearest``: ``cv2.remap(..., INTER_NEAREST, borderValue=0)`` with
  float32 maps (each coordinate rounded to the nearest integer, ties to
  even);
- ``rgb_to_gray``: ``cv2.cvtColor(..., COLOR_RGB2GRAY)`` of uint8 (the
  15-bit fixed point ``gray15``, which ``data.prepare.rgb_to_gray`` uses
  on the host);
- ``erode`` / ``dilate`` with a ones kernel: OpenCV turns ``iterations``
  of a rectangle into one larger rectangle, and its default border value
  neither erodes nor dilates from the image border.

Images are [H, W] or [H, W, C] tensors; sizes are (width, height) as in
cv2.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _nearest_index(dst: int, src: int, device) -> torch.Tensor:
    """``resizeNN``'s offsets: min(floor(i * (1 / (dst / src))), src - 1)."""
    ifx = 1.0 / (dst / src)
    idx = np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64),
                     src - 1)
    return torch.from_numpy(idx).to(device)


def resize_nearest(img: torch.Tensor, size) -> torch.Tensor:
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)``."""
    w, h = size
    H, W = img.shape[:2]
    ys = _nearest_index(h, H, img.device)
    xs = _nearest_index(w, W, img.device)
    return img[ys][:, xs]


def _area_table(src: int, dst: int):
    """``computeResizeAreaTab``: (dst index, src index, float32 weight)
    triples of a shrink from ``src`` to ``dst`` samples."""
    scale = src / dst
    di, si, alpha = [], [], []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1 = int(np.ceil(fsx1))
        sx2 = min(int(np.floor(fsx2)), src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx)
            si.append(sx1 - 1)
            alpha.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            di.append(dx)
            si.append(sx)
            alpha.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            di.append(dx)
            si.append(sx2)
            alpha.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return (np.asarray(di), np.asarray(si),
            np.asarray(alpha, np.float64).astype(np.float32))


def _round_half_even_u8(x: torch.Tensor) -> torch.Tensor:
    """``saturate_cast<uchar>`` of float: round to nearest even, clamp."""
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def resize_area(img: torch.Tensor, size) -> torch.Tensor:
    """``cv2.resize(img, size, interpolation=cv2.INTER_AREA)`` of a uint8
    image shrunk in both axes (or kept)."""
    w, h = size
    H, W = img.shape[:2]
    if (w, h) == (W, H):
        return img.clone()
    if w > W or h > H:
        raise ValueError(f"resize_area mirrors shrinking only: "
                         f"{(W, H)} -> {(w, h)}")
    x = img if img.dim() == 3 else img[..., None]
    sx, sy = W / w, H / h
    if sx == int(sx) and sy == int(sy):
        # resizeAreaFast_: the block sum times the float 1 / area
        kx, ky = int(sx), int(sy)
        blocks = x[:h * ky, :w * kx].to(torch.int32).reshape(
            h, ky, w, kx, -1).sum((1, 3))
        scale = np.float32(1.0) / np.float32(kx * ky)
        if kx == 2 and ky == 2:
            out = ((blocks + 2) >> 2).to(torch.uint8)
        else:
            out = _round_half_even_u8(blocks.to(torch.float32)
                                      * float(scale))
    else:
        out = _resize_area_weights(x, w, h)
    return out if img.dim() == 3 else out[..., 0]


def _resize_area_weights(x: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """``ResizeArea_Invoker``: each source row's horizontal weighted sum
    (float32, table order), then the rows weighted into the destination
    row in order, rounded once."""
    H, W, C = x.shape
    dev = x.device
    xdi, xsi, xal = _area_table(W, w)
    ydi, ysi, yal = _area_table(H, h)
    src = x.to(torch.float32)
    # horizontal: buf[sy, dx] = sum over the table's entries in order
    rows = torch.zeros((H, w, C), dtype=torch.float32, device=dev)
    # the table's entries of one destination index are consecutive:
    # accumulate slot by slot, in table order
    counts = np.bincount(xdi, minlength=w)
    slot = np.concatenate([np.arange(c) for c in counts])
    for j in range(int(counts.max())):
        sel = slot == j
        d = torch.from_numpy(xdi[sel]).to(dev)
        s = torch.from_numpy(xsi[sel]).to(dev)
        a = torch.from_numpy(xal[sel]).to(dev)
        rows[:, d] = rows[:, d] + src[:, s] * a[None, :, None]
    out = torch.zeros((h, w, C), dtype=torch.float32, device=dev)
    counts = np.bincount(ydi, minlength=h)
    slot = np.concatenate([np.arange(c) for c in counts])
    for j in range(int(counts.max())):
        sel = slot == j
        d = torch.from_numpy(ydi[sel]).to(dev)
        s = torch.from_numpy(ysi[sel]).to(dev)
        b = torch.from_numpy(yal[sel]).to(dev)
        out[d] = out[d] + rows[s] * b[:, None, None]
    return _round_half_even_u8(out)


def _linear_coeffs(src: int, dst: int):
    """INTER_LINEAR's source indices and 11-bit coefficients along one
    axis: fx = (float)((d + 0.5) * scale - 0.5), clamped at the edges, each
    coefficient rounded on its own."""
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    lo = s < 0
    f[lo], s[lo] = 0, 0
    hi = s >= src - 1
    f[hi], s[hi] = 0, src - 1
    c0 = np.round((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    c1 = np.round(f * np.float32(2048)).astype(np.int64)
    return s, np.minimum(s + 1, src - 1), c0, c1


def resize_linear(img: torch.Tensor, size) -> torch.Tensor:
    """``cv2.resize(img, size)`` (INTER_LINEAR) of a uint8 image shrunk in
    both axes (or kept)."""
    w, h = size
    H, W = img.shape[:2]
    if w > W or h > H:
        raise ValueError(f"resize_linear mirrors shrinking only: "
                         f"{(W, H)} -> {(w, h)}")
    if W == 2 * w and H == 2 * h:
        return resize_area(img, size)
    x = (img if img.dim() == 3 else img[..., None]).to(torch.int64)
    dev = img.device
    xs0, xs1, a0, a1 = (torch.from_numpy(v).to(dev)
                        for v in _linear_coeffs(W, w))
    ys0, ys1, b0, b1 = (torch.from_numpy(v).to(dev)
                        for v in _linear_coeffs(H, h))
    # HResizeLinear: S[sx] * a0 + S[sx + 1] * a1 (S[sx] * 2048 at the
    # right edge, where the coefficients are (2048, 0))
    rows = x[:, xs0] * a0[None, :, None] + x[:, xs1] * a1[None, :, None]
    r0, r1 = rows[ys0], rows[ys1]
    # VResizeLinear<uchar>: ((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4))
    # >> 16) + 2) >> 2
    out = (((b0[:, None, None] * (r0 >> 4)) >> 16)
           + ((b1[:, None, None] * (r1 >> 4)) >> 16) + 2) >> 2
    out = out.clamp(0, 255).to(torch.uint8)
    return out if img.dim() == 3 else out[..., 0]


def remap_nearest(img: torch.Tensor, map_x: torch.Tensor,
                  map_y: torch.Tensor) -> torch.Tensor:
    """``cv2.remap(img, map_x, map_y, INTER_NEAREST, borderValue=0)`` with
    float32 maps: (x, y) rounded to the nearest integer (ties to even);
    outside the image 0."""
    H, W = img.shape[:2]
    xi = torch.round(map_x).to(torch.int64)
    yi = torch.round(map_y).to(torch.int64)
    inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    v = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
    return torch.where(inside, v, torch.zeros_like(v))


def _rect_size(k: int, iterations: int) -> int:
    return k + (iterations - 1) * (k - 1)


def dilate(img: torch.Tensor, k: int = 5, iterations: int = 1):
    """``cv2.dilate(img, np.ones((k, k)), iterations=...)`` of a uint8
    [H, W]: the max over a (k + (it - 1)(k - 1))^2 window clipped to the
    image."""
    n = _rect_size(k, iterations)
    x = img[None, None].to(torch.float32)
    y = F.max_pool2d(F.pad(x, (n // 2,) * 4, value=-1.0), n, stride=1)
    return y[0, 0].to(img.dtype)


def erode(img: torch.Tensor, k: int = 5, iterations: int = 1):
    """``cv2.erode`` likewise: the min over the clipped window."""
    n = _rect_size(k, iterations)
    x = img[None, None].to(torch.float32)
    y = -F.max_pool2d(F.pad(-x, (n // 2,) * 4, value=-256.0), n, stride=1)
    return y[0, 0].to(img.dtype)


def gray15(r, g, b):
    """OpenCV 5's RGB2GRAY fixed point, 0.299 R + 0.587 G + 0.114 B in
    15-bit coefficients, rounded, of integer arrays or tensors wide
    enough for the products."""
    return (r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` of uint8 [H, W, 3] on
    the tensor's device (``data.prepare.rgb_to_gray`` on the host)."""
    x = img.to(torch.int32)
    return gray15(x[..., 0], x[..., 1], x[..., 2]).to(torch.uint8)
