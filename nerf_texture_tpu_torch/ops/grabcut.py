"""``cv2.grabCut`` in PyTorch, float64 on the session's device.

A port of OpenCV's ``imgproc/src/grabcut.cpp`` as the JAX package calls it
(``nerf_texture_tpu/data/segmenter.py``, ``data/prepare.py``): two
5-component colour GMMs in OpenCV's 65-double layout (5 weights, 15
means, 45 covariances), k-means++ initialisation (``ops/kmeans.py``),
component assignment, learning (0.01 added to the diagonal of a
covariance whose determinant is <= 1e-6), ``beta`` from the mean squared
colour difference over the left, up-left, up and up-right neighbours,
N-links ``gamma`` = 50 (over sqrt(2) on the diagonals), T-links ``lambda``
= 9 gamma on hard labels and ``-log`` of the other side's GMM on
probable ones, folded into one net weight per node as
``GCGraph::addTermWeights`` folds them, and the cut (``ops/maxflow.py``).
Only ``GC_PR_*`` pixels change.

Every sum that OpenCV takes over pixels (the GMM statistics, ``beta``)
adds integers in float64 below 2^53, so it is exact in any order; the
per-pixel arithmetic follows grabcut.cpp's expressions operation by
operation, so the models agree with cv2's to the last bit or so (the
device's ``exp`` / ``log`` may round differently in the last place).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .kmeans import CvRNG, kmeans
from .maxflow import grid_capacities, min_cut

GC_BGD, GC_FGD, GC_PR_BGD, GC_PR_FGD = 0, 1, 2, 3
GC_INIT_WITH_RECT, GC_INIT_WITH_MASK, GC_EVAL, GC_EVAL_FREEZE_MODEL = (
    0, 1, 2, 3)
COMPONENTS = 5
GAMMA = 50.0
LAMBDA = 9 * GAMMA
# gamma / std::sqrt(2.0f): the float square root, widened
GAMMA_DIAG = GAMMA / float(np.sqrt(np.float32(2.0)))


class GMM:
    """A 5-component GMM over RGB in OpenCV's 65-double model layout."""

    def __init__(self, model: torch.Tensor, singular_fix: float = 0.0):
        self.model = model.reshape(-1).to(torch.float64)
        if self.model.numel() != 13 * COMPONENTS:
            raise ValueError(f"a GMM model has 65 doubles, not "
                             f"{self.model.numel()}")
        self._inverse(singular_fix)

    @property
    def coefs(self):
        return self.model[:COMPONENTS]

    @property
    def means(self):
        return self.model[COMPONENTS:4 * COMPONENTS].reshape(COMPONENTS, 3)

    @property
    def covs(self):
        return self.model[4 * COMPONENTS:].reshape(COMPONENTS, 9)

    def _inverse(self, singular_fix: float):
        """``calcInverseCovAndDeterm`` of every component with weight > 0
        (the others are never evaluated)."""
        c = self.covs.clone()

        def det(c):
            return (c[:, 0] * (c[:, 4] * c[:, 8] - c[:, 5] * c[:, 7])
                    - c[:, 1] * (c[:, 3] * c[:, 8] - c[:, 5] * c[:, 6])
                    + c[:, 2] * (c[:, 3] * c[:, 7] - c[:, 4] * c[:, 6]))

        d = det(c)
        live = self.coefs > 0
        if singular_fix > 0:
            fix = live & (d <= 1e-6)
            if bool(fix.any()):
                for j in (0, 4, 8):
                    c[:, j] = torch.where(fix, c[:, j] + singular_fix,
                                          c[:, j])
                d = torch.where(fix, det(c), d)
                self.model[4 * COMPONENTS:] = c.reshape(-1)
        if bool((live & ~(d > np.finfo(np.float64).eps)).any()):
            raise ValueError("a GMM component's covariance is singular")
        inv_d = 1.0 / torch.where(live, d, 1.0)
        # inv[ci, r, col] = inverseCovs[ci][r][col]
        inv = torch.stack([
            (c[:, 4] * c[:, 8] - c[:, 5] * c[:, 7]) * inv_d,
            -(c[:, 1] * c[:, 8] - c[:, 2] * c[:, 7]) * inv_d,
            (c[:, 1] * c[:, 5] - c[:, 2] * c[:, 4]) * inv_d,
            -(c[:, 3] * c[:, 8] - c[:, 5] * c[:, 6]) * inv_d,
            (c[:, 0] * c[:, 8] - c[:, 2] * c[:, 6]) * inv_d,
            -(c[:, 0] * c[:, 5] - c[:, 2] * c[:, 3]) * inv_d,
            (c[:, 3] * c[:, 7] - c[:, 4] * c[:, 6]) * inv_d,
            -(c[:, 0] * c[:, 7] - c[:, 1] * c[:, 6]) * inv_d,
            (c[:, 0] * c[:, 4] - c[:, 1] * c[:, 3]) * inv_d], 1)
        self.inv = inv.reshape(COMPONENTS, 3, 3)
        self.det = d

    def component_probs(self, color: torch.Tensor) -> torch.Tensor:
        """[5, N] unweighted densities of float64 colours [N, 3]:
        1 / sqrt(det) * exp(-0.5 * d^T inv d), 0 for a weight of 0."""
        out = []
        for ci in range(COMPONENTS):
            if not float(self.coefs[ci]) > 0:
                out.append(color.new_zeros(color.shape[0]))
                continue
            m = self.means[ci]
            i = self.inv[ci]
            d0 = color[:, 0] - m[0]
            d1 = color[:, 1] - m[1]
            d2 = color[:, 2] - m[2]
            mult = (d0 * (d0 * i[0, 0] + d1 * i[1, 0] + d2 * i[2, 0])
                    + d1 * (d0 * i[0, 1] + d1 * i[1, 1] + d2 * i[2, 1])
                    + d2 * (d0 * i[0, 2] + d1 * i[1, 2] + d2 * i[2, 2]))
            out.append((1.0 / torch.sqrt(self.det[ci]))
                       * torch.exp(-0.5 * mult))
        return torch.stack(out)

    def prob(self, color: torch.Tensor) -> torch.Tensor:
        """The mixture density: sum of weight * density, in component
        order."""
        p = self.component_probs(color)
        res = torch.zeros_like(p[0])
        for ci in range(COMPONENTS):
            res = res + self.coefs[ci] * p[ci]
        return res

    def which(self, color: torch.Tensor) -> torch.Tensor:
        """``whichComponent``: the first component of the largest density
        (0 when every density is 0)."""
        return torch.argmax(self.component_probs(color), 0)

    def learn(self, color: torch.Tensor, comp: torch.Tensor) -> "GMM":
        """``initLearning`` / ``addSample`` / ``endLearning`` over integer
        colours [N, 3] (float64) with component labels [N]: the sums are
        exact, then OpenCV's means, covariances and weights, with the 0.01
        singular fix.  A component without samples gets weight 0 and keeps
        this model's mean and covariance, as OpenCV's does."""
        oh = torch.nn.functional.one_hot(comp, COMPONENTS).to(torch.float64)
        n = oh.sum(0)                                        # [5]
        sums = oh.T @ color                                  # [5, 3]
        prods = oh.T @ (color[:, :, None] * color[:, None, :]).reshape(-1, 9)
        total = float(n.sum())
        model = self.model.clone()
        live = n > 0
        inv_n = 1.0 / torch.where(live, n, 1.0)
        m = sums * inv_n[:, None]
        cov = prods * inv_n[:, None] - (m[:, :, None]
                                        * m[:, None, :]).reshape(-1, 9)
        model[:COMPONENTS] = torch.where(live, n / total, 0.0)
        model[COMPONENTS:4 * COMPONENTS] = torch.where(
            live[:, None], m, self.means).reshape(-1)
        model[4 * COMPONENTS:] = torch.where(live[:, None], cov,
                                             self.covs).reshape(-1)
        return GMM(model, singular_fix=0.01)


def calc_beta(img: torch.Tensor) -> float:
    """``calcBeta``: 1 / (2 * mean squared colour difference) over the
    left, up-left, up and up-right neighbour pairs (0 for a flat image)."""
    x = img.to(torch.float64)
    H, W = x.shape[:2]

    def sq(a, b):
        d = a - b
        return float((d * d).sum())

    s = (sq(x[:, 1:], x[:, :-1]) + sq(x[1:, 1:], x[:-1, :-1])
         + sq(x[1:], x[:-1]) + sq(x[1:, :-1], x[:-1, 1:]))
    if s <= np.finfo(np.float64).eps:
        return 0.0
    return 1.0 / (2 * s / (4 * W * H - 3 * W - 3 * H + 2))


def n_weights(img: torch.Tensor, beta: float) -> torch.Tensor:
    """``calcNWeights`` as the grid's capacities [8, H, W]."""
    x = img.to(torch.float64)
    H, W = x.shape[:2]

    def w(dy, dx, g):
        out = x.new_zeros((H, W))
        ys = slice(max(0, -dy), H)
        xs = slice(max(0, -dx), W - max(0, dx))
        d = x[ys, xs] - x[max(0, -dy) + dy:H + dy,
                          max(0, -dx) + dx:W - max(0, dx) + dx]
        dd = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        out[ys, xs] = g * torch.exp(-beta * dd)
        return out

    return grid_capacities(w(0, -1, GAMMA), w(-1, -1, GAMMA_DIAG),
                           w(-1, 0, GAMMA), w(-1, 1, GAMMA_DIAG))


def t_weights(img: torch.Tensor, mask: torch.Tensor, bgd: GMM,
              fgd: GMM) -> torch.Tensor:
    """Each node's net terminal weight [H, W]: source weight - sink
    weight (``addTermWeights`` on a fresh vertex)."""
    H, W = mask.shape
    color = img.reshape(-1, 3).to(torch.float64)
    m = mask.reshape(-1)
    from_source = -torch.log(bgd.prob(color))
    to_sink = -torch.log(fgd.prob(color))
    probable = (m == GC_PR_BGD) | (m == GC_PR_FGD)
    w = torch.where(probable, from_source - to_sink,
                    torch.where(m == GC_BGD, -LAMBDA, LAMBDA))
    return w.reshape(H, W)


def _init_gmms(img: torch.Tensor, mask: torch.Tensor, bgd: GMM, fgd: GMM,
               rng: CvRNG):
    """``initGMMs``: k-means of each side's colours (raster order), then
    each model learnt from the cluster labels."""
    color = img.reshape(-1, 3)
    bg = ((mask == GC_BGD) | (mask == GC_PR_BGD)).reshape(-1)
    out = []
    for gmm, side in ((bgd, bg), (fgd, ~bg)):
        samples = color[side]
        if samples.shape[0] == 0:
            raise ValueError("grabcut: one side of the mask is empty (cv2 "
                             "asserts !bgdSamples.empty() && "
                             "!fgdSamples.empty())")
        labels = kmeans(samples.to(torch.float32),
                        min(COMPONENTS, samples.shape[0]), rng)
        out.append(gmm.learn(samples.to(torch.float64), labels))
    return out


def _assign_learn(color, bg, bgd: GMM, fgd: GMM, learn: bool):
    if not learn:
        return bgd, fgd
    comp = torch.where(bg, bgd.which(color), fgd.which(color))
    return bgd.learn(color[bg], comp[bg]), fgd.learn(color[~bg], comp[~bg])


def grabcut(img: torch.Tensor, mask: torch.Tensor | None, rect,
            bgd_model: torch.Tensor | None, fgd_model: torch.Tensor | None,
            iter_count: int, mode: int, rng: CvRNG | None = None,
            timings: dict | None = None):
    """``cv2.grabCut(img, mask, rect, bgdModel, fgdModel, iterCount,
    mode)`` on uint8 img [H, W, 3] (the caller's channel order) and a
    uint8 label mask [H, W] (ignored with INIT_WITH_RECT).  Models are
    float64 [65] tensors or None for zeros.  ``rng`` is the thread RNG
    that the INIT modes' k-means draws from (advanced in place).  Returns
    (mask, bgd_model, fgd_model), new tensors on img's device.  With
    ``timings`` the seconds of the k-means, of the rest of the GMM
    work (N-links, assignment, learning, T-links) and of the cuts are
    added to its "kmeans", "gmm" and "cut" keys (synchronising the
    device)."""
    dev = img.device
    if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"grabcut: image must be uint8 [H, W, 3], not "
                         f"{img.dtype} {tuple(img.shape)}")
    H, W = img.shape[:2]

    def tick():
        if timings is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def model_of(m):
        return (torch.zeros(13 * COMPONENTS, dtype=torch.float64, device=dev)
                if m is None else
                torch.as_tensor(m, dtype=torch.float64).reshape(-1).to(dev))

    t0 = tick()
    bgd, fgd = GMM(model_of(bgd_model)), GMM(model_of(fgd_model))
    if mode == GC_INIT_WITH_RECT:
        mask = torch.full((H, W), GC_BGD, dtype=torch.uint8, device=dev)
        x, y, w, h = (int(v) for v in rect)
        x, y = max(0, x), max(0, y)
        w, h = min(w, W - x), min(h, H - y)
        if w > 0 and h > 0:
            mask[y:y + h, x:x + w] = GC_PR_FGD
    else:
        mask = torch.as_tensor(mask).to(dev).clone()
        if mask.shape != (H, W) or mask.dtype != torch.uint8:
            raise ValueError(f"grabcut: mask must be uint8 {(H, W)}")
        if bool((mask > GC_PR_FGD).any()):
            raise ValueError("grabcut: mask values must be GC_BGD, GC_FGD, "
                             "GC_PR_BGD or GC_PR_FGD")
    kmeans_s = 0.0
    if mode in (GC_INIT_WITH_RECT, GC_INIT_WITH_MASK):
        t1 = tick()
        bgd, fgd = _init_gmms(img, mask, bgd, fgd,
                              rng if rng is not None else CvRNG())
        kmeans_s = tick() - t1
        t0 += kmeans_s
    if iter_count <= 0:
        return mask, bgd.model, fgd.model
    if mode == GC_EVAL_FREEZE_MODEL:
        iter_count = 1
    cap = n_weights(img, calc_beta(img))
    color = img.reshape(-1, 3).to(torch.float64)
    t1 = tick()
    gmm_s = t1 - t0
    cut_s = 0.0
    for _ in range(iter_count):
        t0 = tick()
        bg = ((mask == GC_BGD) | (mask == GC_PR_BGD)).reshape(-1)
        bgd, fgd = _assign_learn(color, bg, bgd, fgd,
                                 learn=mode != GC_EVAL_FREEZE_MODEL)
        weight = t_weights(img, mask, bgd, fgd)
        t1 = tick()
        source = min_cut(cap, weight)
        t2 = tick()
        probable = (mask == GC_PR_BGD) | (mask == GC_PR_FGD)
        mask = torch.where(probable, torch.where(source, GC_PR_FGD,
                                                 GC_PR_BGD).to(torch.uint8),
                           mask)
        gmm_s += t1 - t0
        cut_s += t2 - t1
    if timings is not None:
        timings["kmeans"] = timings.get("kmeans", 0.0) + kmeans_s
        timings["gmm"] = timings.get("gmm", 0.0) + gmm_s
        timings["cut"] = timings.get("cut", 0.0) + cut_s
    return mask, bgd.model, fgd.model


def foreground(mask: torch.Tensor) -> torch.Tensor:
    """GC_FGD or GC_PR_FGD."""
    return (mask == GC_FGD) | (mask == GC_PR_FGD)

