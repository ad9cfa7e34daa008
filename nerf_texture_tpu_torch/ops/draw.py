"""The segmenter's stroke rasteriser: ``cv2.polylines(img, [pts], False,
label, thickness=2 * radius)`` (LINE_8) and ``cv2.circle(img, pt, radius,
label, -1)`` on a uint8 label map, bit for bit, in host numpy.

OpenCV draws a thick line segment clipped to the image grown by the
thickness on every side, in fixed point (``XY_SHIFT`` 16 bits): a convex
quad around it filled scanline by scanline, its edges drawn as
fixed-point lines (``Line2``, clipped to the image), and a filled
integer circle (Bresenham-style, ``Circle``) at its unclipped cap points:
both ends of the first segment, the far end of each later one.  A
polyline of one point draws nothing; the segmenter then draws the filled
circle.  Points may lie outside the image.
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _hline(img, y: int, x1: int, x2: int, value: int):
    H, W = img.shape
    if 0 <= y < H:
        x1, x2 = max(x1, 0), min(x2, W - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = value


def circle(img: np.ndarray, center, radius: int, value: int):
    """``Circle(img, center, radius, color, fill=1)``: the union of the
    horizontal spans of OpenCV's integer circle."""
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, value)
        _hline(img, cy + dy, cx - dx, cx + dx, value)
        _hline(img, cy - dx, cx - dy, cx + dy, value)
        _hline(img, cy + dx, cx - dy, cx + dy, value)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _clip_line(W: int, H: int, p1, p2):
    """``clipLine`` on the fixed-point image size; returns the clipped
    points, or None when the segment misses the image."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = W - 1, H - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _put(img, x: int, y: int, value: int):
    H, W = img.shape
    if 0 <= x < W and 0 <= y < H:
        img[y, x] = value


def _line2(img, p1, p2, value: int):
    """``Line2``: a fixed-point line, clipped to the image: from p1 + 1/2
    in steps of one pixel along the major axis and the slope (truncated
    to 16 bits) along the other, (p2 - p1) >> 16 + 1 points, and p2
    rounded."""
    H, W = img.shape
    clipped = _clip_line(W << XY_SHIFT, H << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _cdiv((y2 - y1) * XY_ONE, (x2 - x1) | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _cdiv((x2 - x1) * XY_ONE, (y2 - y1) | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, (x2 + (XY_ONE >> 1)) >> XY_SHIFT,
         (y2 + (XY_ONE >> 1)) >> XY_SHIFT, value)
    while ecount >= 0:
        _put(img, x1 >> XY_SHIFT, y1 >> XY_SHIFT, value)
        x1 += x_step
        y1 += y_step
        ecount -= 1


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_convex(img, v, value: int):
    """``FillConvexPoly`` of fixed-point points (shift = XY_SHIFT), LINE_8:
    the edges as ``Line2`` lines, then the scanline fill."""
    H, W = img.shape
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    ymin = ymax = v[0][1]
    xmin = xmax = v[0][0]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line2(img, p0, p, value)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= W or ymin >= H:
        return
    ymax = min(ymax, H - 1)
    edges = npts
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0, di = e["idx"], e["di"]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs) * 2 + (ty - y),
                                        2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < W:
                _hline(img, y, xx1, xx2, value)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _thick_line(img, p0, p1, value: int, thickness: int, flags: int):
    """``ThickLine`` (thickness > 1, LINE_8, shift 0): the segment clipped
    to the image grown by ``thickness`` on every side, its quad, and the
    caps at the unclipped points."""
    H, W = img.shape
    t = thickness
    caps = p0, p1
    clipped = _clip_line(W + 2 * t, H + 2 * t, (p0[0] + t, p0[1] + t),
                         (p1[0] + t, p1[1] + t))
    if clipped is not None:
        (x0, y0), (x1, y1) = clipped
        _thick_quad(img, (x0 - t, y0 - t), (x1 - t, y1 - t), value, t)
    radius = ((thickness << (XY_SHIFT - 1)) + (XY_ONE >> 1)) >> XY_SHIFT
    for i in range(2):
        if flags & (i + 1):
            circle(img, caps[i], radius, value)


def _thick_quad(img, p0, p1, value: int, thickness: int):
    """The filled quad of a thick segment in fixed point."""
    p0 = (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT)
    p1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    dx = (p0[0] - p1[0]) * (1.0 / XY_ONE)
    dy = (p1[1] - p0[1]) * (1.0 / XY_ONE)
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / np.sqrt(r)
        ddx = int(np.rint(dy * r))
        ddy = int(np.rint(dx * r))
        _fill_convex(img, [(p0[0] + ddx, p0[1] + ddy),
                           (p0[0] - ddx, p0[1] - ddy),
                           (p1[0] - ddx, p1[1] - ddy),
                           (p1[0] + ddx, p1[1] + ddy)], value)


def polyline(img: np.ndarray, points, value: int, thickness: int):
    """``cv2.polylines(img, [points], False, value, thickness)`` (LINE_8,
    thickness > 1) on a uint8 [H, W], in place."""
    if thickness <= 1:
        raise ValueError("polyline mirrors thick lines only (thickness > 1)")
    pts = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    flags = 3
    for a, b in zip(pts[:-1], pts[1:]):
        _thick_line(img, a, b, value, thickness, flags)
        flags = 2
