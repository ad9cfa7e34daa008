"""Batched ray-triangle and point-triangle primitives (port of
``nerf_texture_tpu/geometry/triangle.py``): each query tests a batch of
candidate triangles with plain tensor math, no tree traversal.
"""

from __future__ import annotations

import torch


def moller_trumbore(ray_o, ray_d, v0, v1, v2, eps: float = 1e-9):
    """Ray-triangle intersection of rays ray_o / ray_d [..., 3] with
    triangles v0 / v1 / v2 [..., 3] (broadcastable).

    Returns (t, hit): [...] distance (+inf on a miss) and bool mask; only
    t >= 0 counts (rays, not lines)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = torch.linalg.cross(ray_d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    inv_det = torch.where(torch.abs(det) > eps, 1.0 / det, 0.0)
    tvec = ray_o - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = torch.sum(ray_d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = ((torch.abs(det) > eps) & (u >= -eps) & (v >= -eps)
           & (u + v <= 1.0 + eps) & (t >= 0.0))
    return torch.where(hit, t, torch.inf), hit


def _closest_weights(d1, d2, d3, d4, d5, d6):
    """Barycentric weights (u, v, w) of the closest point of a triangle
    from the six edge dot products of the region-partition algorithm
    (Ericson, Real-Time Collision Detection 5.1.5), branch-free."""
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    safe = torch.where(torch.abs(denom) > 1e-20, denom, 1.0)
    v_face = vb / safe
    w_face = vc / safe
    ab_den = d1 - d3
    t_ab = torch.clamp(d1 / torch.where(torch.abs(ab_den) > 1e-20, ab_den,
                                        1.0), 0.0, 1.0)
    ac_den = d2 - d6
    t_ac = torch.clamp(d2 / torch.where(torch.abs(ac_den) > 1e-20, ac_den,
                                        1.0), 0.0, 1.0)
    bc_den = (d4 - d3) + (d5 - d6)
    t_bc = torch.clamp((d4 - d3) / torch.where(torch.abs(bc_den) > 1e-20,
                                               bc_den, 1.0), 0.0, 1.0)
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    rest = ~in_a & ~in_b & ~in_c
    on_ab = rest & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = rest & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = rest & (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    w = torch.where
    u = w(in_a, 1.0, w(in_b, 0.0, w(in_c, 0.0, w(
        on_ab, 1.0 - t_ab, w(on_ac, 1.0 - t_ac, w(
            on_bc, 0.0, 1.0 - v_face - w_face))))))
    v = w(in_a, 0.0, w(in_b, 1.0, w(in_c, 0.0, w(
        on_ab, t_ab, w(on_ac, 0.0, w(on_bc, 1.0 - t_bc, v_face))))))
    return u, v, 1.0 - u - v


def point_triangle_closest(p, v0, v1, v2):
    """Closest point on triangle(s) v0 / v1 / v2 [..., 3] to point(s)
    p [..., 3] (broadcastable).

    Returns (dist_sq [...], closest [..., 3], bary [..., 3])."""
    ab = v1 - v0
    ac = v2 - v0
    ap = p - v0
    bp = p - v1
    cp = p - v2
    u, v, w = _closest_weights(
        torch.sum(ab * ap, dim=-1), torch.sum(ac * ap, dim=-1),
        torch.sum(ab * bp, dim=-1), torch.sum(ac * bp, dim=-1),
        torch.sum(ab * cp, dim=-1), torch.sum(ac * cp, dim=-1))
    bary = torch.stack([u, v, w], dim=-1)
    closest = u[..., None] * v0 + v[..., None] * v1 + w[..., None] * v2
    dist_sq = torch.sum((p - closest) ** 2, dim=-1)
    return dist_sq, closest, bary


def points_to_barycentric(triangles, points, eps: float = 1e-5):
    """Barycentric coordinates of points [..., 3] in triangles
    [..., 3, 3] by the areas of the sub-triangles."""
    p2v = triangles - points[..., None, :]

    def area(a, b):
        return torch.linalg.norm(torch.linalg.cross(p2v[..., a, :],
                                                    p2v[..., b, :]), dim=-1)

    bary = torch.stack([area(1, 2), area(2, 0), area(0, 1)], dim=-1)
    return bary / (torch.sum(bary, dim=-1, keepdim=True) + eps)
