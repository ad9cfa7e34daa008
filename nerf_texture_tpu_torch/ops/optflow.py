"""``cv2.calcOpticalFlowFarneback`` in PyTorch (float32, with OpenCV's
float64 sums), on the session's device.

A port of OpenCV's ``video/src/optflowgf.cpp`` (the CPU path) at the
parameters the segmenter calls it with: ``pyr_scale`` 0.5, ``levels`` 3,
``winsize`` 21, ``iterations`` 3, ``poly_n`` 5, ``poly_sigma`` 1.2,
``flags`` 0 (the box window, no initial flow).  ``farneback(prev, next)``
returns the flow [H, W, 2] (x, y) with prev(y, x) ~ next(y + fy, x + fx).

- The pyramid drops levels below 32 pixels: ``levels`` 3 gives up to 4
  scales (1, 1/2, 1/4, 1/8).
- Each level blurs the full image with a Gaussian of sigma = (1/scale -
  1) / 2 (kernel size round(5 sigma) | 1, at least 3; at scale 1 the
  fixed [1/4, 1/2, 1/4]) before the linear resize to the level's size.
- Polynomial expansion (``FarnebackPolyExp``): separable Gaussian-weighted
  fits of 1, x, y, x^2, y^2, xy with replicated borders.
- ``FarnebackUpdateMatrices`` (with OpenCV's border weights) and
  ``FarnebackUpdateFlow_Blur``: a 21 x 21 box over the matrices, each
  pixel's 2 x 2 solve with 1e-3 added to the determinant; 3 iterations.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MIN_SIZE = 32
# the JAX call's parameters: calcOpticalFlowFarneback(..., 0.5, 3, 21, 3,
# 5, 1.2, 0)
PYR_SCALE, LEVELS, WINSIZE, ITERATIONS, POLY_N, POLY_SIGMA = (
    0.5, 3, 21, 3, 5, 1.2)
_BORDER = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


def _gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """``getGaussianKernel(n, sigma, CV_32F)``."""
    if n == 3 and sigma <= 0:
        k = np.array([0.25, 0.5, 0.25], np.float32)
    else:
        sigma = sigma if sigma > 0 else ((n - 1) * 0.5 - 1) * 0.3 + 0.8
        x = np.arange(n) - (n - 1) * 0.5
        k = np.exp(-0.5 / (sigma * sigma) * x * x).astype(np.float32)
    s = float(k.astype(np.float64).sum())
    return (k.astype(np.float64) * (1.0 / s)).astype(np.float32)


def _reflect101(n: int, pad: int) -> np.ndarray:
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def _sep_filter(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable symmetric filter along x then y, BORDER_REFLECT_101, in
    float32: k[0] * x[i] + sum_j k[j] * (x[i - j] + x[i + j])."""
    r = len(k) // 2
    kt = torch.from_numpy(k).to(img.device)
    H, W = img.shape
    out = img
    for axis, n in ((1, W), (0, H)):
        idx = torch.from_numpy(_reflect101(n, r)).to(img.device)
        x = out.index_select(axis, idx)

        def tap(j):
            return x.narrow(axis, r + j, n)

        acc = tap(0) * kt[r]
        for j in range(1, r + 1):
            acc = acc + (tap(-j) + tap(j)) * kt[r + j]
        out = acc
    return out


def _linear_axis(src: int, dst: int):
    """INTER_LINEAR's float taps along one axis (OpenCV's clamping)."""
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    lo = s < 0
    f[lo], s[lo] = 0, 0
    hi = s >= src - 1
    f[hi], s[hi] = 0, src - 1
    return s, np.minimum(s + 1, src - 1), (np.float32(1) - f), f


def resize_linear_f32(img: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """``cv2.resize(img, (w, h))`` (INTER_LINEAR) of a float32 [H, W] or
    [H, W, C] image; a halving takes OpenCV's area path (the mean of 2x2)."""
    H, W = img.shape[:2]
    if W == 2 * w and H == 2 * h:
        x = img[:2 * h, :2 * w]
        return ((x[0::2, 0::2] + x[0::2, 1::2])
                + (x[1::2, 0::2] + x[1::2, 1::2])) * 0.25
    dev = img.device
    x0, x1, a0, a1 = (torch.from_numpy(v).to(dev)
                      for v in _linear_axis(W, w))
    # rows: the source row index clamped, the weight kept (OpenCV clamps
    # the row pointers only)
    scale = H / h
    fy = ((np.arange(h) + 0.5) * scale - 0.5).astype(np.float32)
    sy = np.floor(fy).astype(np.int64)
    fy = (fy - sy.astype(np.float32)).astype(np.float32)
    y0 = torch.from_numpy(np.clip(sy, 0, H - 1)).to(dev)
    y1 = torch.from_numpy(np.clip(sy + 1, 0, H - 1)).to(dev)
    b0 = torch.from_numpy(np.float32(1) - fy).to(dev)
    b1 = torch.from_numpy(fy).to(dev)
    ex = (slice(None),) + (None,) * (img.dim() - 2)
    rows = img[:, x0] * a0[ex] + img[:, x1] * a1[ex]
    exy = (slice(None), None) + (None,) * (img.dim() - 2)
    return rows[y0] * b0[exy] + rows[y1] * b1[exy]


def _poly_tables(n: int, sigma: float):
    """``FarnebackPrepareGaussian``: g, x g, x^2 g (float32) and the
    entries of the inverse moment matrix."""
    x = np.arange(-n, n + 1)
    g = np.exp(-x * x / (2 * sigma * sigma)).astype(np.float32)
    s = 1.0 / float(g.astype(np.float64).sum())
    g = (g.astype(np.float64) * s).astype(np.float32)
    xg = (x * g.astype(np.float64)).astype(np.float32)
    xxg = (x * x * g.astype(np.float64)).astype(np.float32)
    G = np.zeros((6, 6))
    gy, gx = np.meshgrid(g.astype(np.float64), g.astype(np.float64),
                         indexing="ij")
    yy, xx = np.meshgrid(x, x, indexing="ij")
    G[0, 0] = (gy * gx).sum()
    G[1, 1] = (gy * gx * xx * xx).sum()
    G[3, 3] = (gy * gx * xx ** 4).sum()
    G[5, 5] = (gy * gx * xx * xx * yy * yy).sum()
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    inv = np.linalg.inv(G)
    return g, xg, xxg, inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5]


def poly_exp(src: torch.Tensor, n: int, sigma: float):
    """``FarnebackPolyExp`` of a float32 [H, W]: [H, W, 5] coefficients
    (y, x, y^2, x^2, xy order of OpenCV's layout)."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_tables(n, sigma)
    H, W = src.shape
    dev = src.device
    f32 = torch.float32

    def rows(k):
        return src[torch.clamp(torch.arange(H, device=dev) + k, 0, H - 1)]

    # vertical part, float32
    r0 = src * float(g[n])
    r1 = torch.zeros_like(src)
    r2 = torch.zeros_like(src)
    for k in range(1, n + 1):
        s0, s1 = rows(-k), rows(k)
        p = s0 + s1
        r0 = r0 + float(g[n + k]) * p
        r1 = r1 + float(xg[n + k]) * (s1 - s0)
        r2 = r2 + float(xxg[n + k]) * p

    # horizontal part: replicated borders, float64 sums
    def cols(r, k):
        return r[:, torch.clamp(torch.arange(W, device=dev) + k, 0,
                                W - 1)]

    g0 = float(g[n])
    b1 = (r0 * g0).double()
    b3 = (r1 * g0).double()
    b5 = (r2 * g0).double()
    b2 = torch.zeros_like(b1)
    b4 = torch.zeros_like(b1)
    b6 = torch.zeros_like(b1)
    for k in range(1, n + 1):
        gk = float(g[n + k])
        tg = (cols(r0, k) + cols(r0, -k)).double()
        b1 = b1 + tg * gk
        b4 = b4 + tg * float(xxg[n + k])
        b2 = b2 + ((cols(r0, k) - cols(r0, -k))
                   * float(xg[n + k])).double()
        b3 = b3 + ((cols(r1, k) + cols(r1, -k)) * gk).double()
        b6 = b6 + ((cols(r1, k) - cols(r1, -k))
                   * float(xg[n + k])).double()
        b5 = b5 + ((cols(r2, k) + cols(r2, -k)) * gk).double()
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], -1).to(f32)


def update_matrices(R0: torch.Tensor, R1: torch.Tensor,
                    flow: torch.Tensor) -> torch.Tensor:
    """``FarnebackUpdateMatrices`` over the whole image: [H, W, 5]."""
    H, W = flow.shape[:2]
    dev = flow.device
    dx, dy = flow[..., 0], flow[..., 1]
    yy, xx = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    fx, fy = xx + dx, yy + dy
    x1, y1 = torch.floor(fx), torch.floor(fy)
    fx, fy = fx - x1, fy - y1
    x1, y1 = x1.to(torch.int64), y1.to(torch.int64)
    inside = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    xc, yc = x1.clamp(0, W - 2), y1.clamp(0, H - 2)
    a00 = (1.0 - fx) * (1.0 - fy)
    a01 = fx * (1.0 - fy)
    a10 = (1.0 - fx) * fy
    a11 = fx * fy
    bil = (a00[..., None] * R1[yc, xc] + a01[..., None] * R1[yc, xc + 1]
           + a10[..., None] * R1[yc + 1, xc]
           + a11[..., None] * R1[yc + 1, xc + 1])
    r2 = torch.where(inside, bil[..., 0], 0.0)
    r3 = torch.where(inside, bil[..., 1], 0.0)
    r4 = torch.where(inside, (R0[..., 2] + bil[..., 2]) * 0.5, R0[..., 2])
    r5 = torch.where(inside, (R0[..., 3] + bil[..., 3]) * 0.5, R0[..., 3])
    r6 = torch.where(inside, (R0[..., 4] + bil[..., 4]) * 0.25,
                     R0[..., 4] * 0.5)
    r2 = (R0[..., 0] - r2) * 0.5
    r3 = (R0[..., 1] - r3) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    def border(n):
        w = np.ones(n, np.float32)
        b = np.asarray(_BORDER, np.float32)[:min(5, n)]
        w[:len(b)] = b
        w2 = np.ones(n, np.float32)
        w2[n - len(b):] = b[::-1]
        return torch.from_numpy(w * w2).to(dev)

    scale = border(H)[:, None] * border(W)[None, :]
    r2, r3, r4, r5, r6 = (v * scale for v in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], -1)


def _box(M: torch.Tensor, win: int) -> torch.Tensor:
    """The win x win box sum of float32 [H, W, 5] with replicated borders,
    in float64."""
    m = win // 2
    x = M.double().permute(2, 0, 1)[None]
    x = F.pad(x, (m, m, m, m), mode="replicate")
    c = torch.cumsum(F.pad(x, (1, 0, 1, 0)), 2).cumsum(3)
    H, W = M.shape[:2]
    s = (c[..., win:, win:] - c[..., :H, win:] - c[..., win:, :W]
         + c[..., :H, :W])
    return s[0].permute(1, 2, 0)


def update_flow(M: torch.Tensor, win: int) -> torch.Tensor:
    """``FarnebackUpdateFlow_Blur``'s solve: the box-blurred matrices'
    2 x 2 systems, 1e-3 added to the determinant."""
    s = _box(M, win) * (1.0 / (win * win))
    g11, g12, g22, h1, h2 = s.unbind(-1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet], -1).float()


def farneback(prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """``cv2.calcOpticalFlowFarneback(prev, next, None, 0.5, 3, 21, 3, 5,
    1.2, 0)`` of two uint8 gray [H, W] tensors: the flow [H, W, 2]
    float32."""
    H, W = prev.shape
    scale = 1.0
    k = 0
    while k < LEVELS:
        scale *= PYR_SCALE
        if W * scale < MIN_SIZE or H * scale < MIN_SIZE:
            break
        k += 1
    levels = k
    imgs = (prev.to(torch.float32), nxt.to(torch.float32))
    flow = None
    for k in range(levels, -1, -1):
        scale = 1.0
        for _ in range(k):
            scale *= PYR_SCALE
        sigma = (1.0 / scale - 1) * 0.5
        ksize = max(int(np.rint(sigma * 5)) | 1, 3)
        width, height = int(np.rint(W * scale)), int(np.rint(H * scale))
        if flow is None:
            flow = torch.zeros((height, width, 2), dtype=torch.float32,
                               device=prev.device)
        else:
            flow = resize_linear_f32(flow, width, height) * (1.0 / PYR_SCALE)
        kern = _gaussian_kernel(ksize, sigma)
        R = [poly_exp(resize_linear_f32(_sep_filter(im, kern), width,
                                        height), POLY_N, POLY_SIGMA)
             for im in imgs]
        M = update_matrices(R[0], R[1], flow)
        for i in range(ITERATIONS):
            flow = update_flow(M, WINSIZE)
            if i < ITERATIONS - 1:
                M = update_matrices(R[0], R[1], flow)
    return flow

