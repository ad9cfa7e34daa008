"""GrabCut's GMM initialisation: ``cv::kmeans`` with k-means++ centres,
drawn from a mirror of ``cv::RNG``.

``cv2.grabCut`` in the INIT modes clusters the colours of each side with
``kmeans(samples, min(5, N), TermCriteria(MAX_ITER, 10, 0), attempts 1,
KMEANS_PP_CENTERS)`` on float32 samples, drawing from the calling thread's
``cv::theRNG()``.  ``kmeans`` below reproduces OpenCV's labels bit for bit
on the same draws: float32 distances (``normL2Sqr``), the double running
sums of k-means++'s D^2 sampling (3 trials a centre, the trial with the
smallest new sum kept), centres summed sample by sample in float32 and
scaled by ``1.f / count``, OpenCV's repair of an empty cluster (the
farthest sample of the largest cluster), and its stopping rule (10
iterations, or a squared centre shift <= FLT_EPSILON^2; the last
iteration does not re-assign labels).

The distances, the assignment and k-means++'s sums run in torch on the
samples' device (float32 elementwise, each operation rounded on its own
as in ``normL2Sqr``, so the card gives the host's labels).  The centre
sums run on the host: OpenCV adds the samples of a cluster one by one in
float32 (``np.add.accumulate`` here), which no reduction on the device
reproduces once a sum passes 2^24.  Random draws come in through
``CvRNG``, which a caller keeps and advances call by call as OpenCV
advances its thread's generator: a ``CvRNG(s)`` runs in step with
``cv2.setRNGSeed(s)``.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
_F32 = np.float32
MAX_ITER = 10       # GrabCut's TermCriteria(MAX_ITER, 10, 0)
SPP_TRIALS = 3      # k-means++ draws a centre


class CvRNG:
    """``cv::RNG``: a multiply-with-carry generator on a 64-bit state."""

    def __init__(self, seed: int = 0xFFFFFFFF):
        self.state = int(seed) & _MASK64 or 0xFFFFFFFF

    def next(self) -> int:
        """``RNG::next``: state = (uint32)state * 4164903690 +
        (state >> 32); returns the low 32 bits."""
        s = self.state
        self.state = ((s & 0xFFFFFFFF) * 4164903690 + (s >> 32)) & _MASK64
        return self.state & 0xFFFFFFFF

    def uniform_double(self) -> float:
        """``(double)rng``: two draws, (hi << 32 | lo) * 2^-64."""
        hi = self.next()
        return ((hi << 32) | self.next()) * 5.4210108624275221700372640043497e-20


def _sq_dist(data, centre):
    """``normL2Sqr`` of float32 rows against one centre, in float32:
    s = 0; for each dim: v = a - b; s += v * v (numpy arrays or tensors)."""
    v = data - centre[None, :]
    s = v[:, 0] * v[:, 0]
    for j in range(1, data.shape[1]):
        s = s + v[:, j] * v[:, j]
    return s


def _pp_centres(data: torch.Tensor, K: int, rng: CvRNG) -> torch.Tensor:
    """``generateCentersPP``: the first centre uniform, then per centre
    ``SPP_TRIALS`` D^2 draws, the one with the smallest new sum kept."""
    N = len(data)
    first = rng.next() % N
    dist = _sq_dist(data, data[first])
    # distances between float rows holding integers are integers, so the
    # double running sums below are exact in any order
    sum0 = float(dist.to(torch.float64).sum())
    chosen = [first]
    for _ in range(1, K):
        best_sum, best_i, best_dist = np.inf, -1, None
        csum = torch.cumsum(dist.to(torch.float64), 0)
        for _ in range(SPP_TRIALS):
            # p -= dist[i] until p <= 0: the first i with csum[i] >= p
            p = torch.tensor([rng.uniform_double() * sum0],
                             dtype=torch.float64, device=data.device)
            ci = min(int(torch.searchsorted(csum, p)), N - 1)
            tdist = torch.minimum(_sq_dist(data, data[ci]), dist)
            s = float(tdist.to(torch.float64).sum())
            if s < best_sum:
                best_sum, best_i, best_dist = s, ci, tdist
        chosen.append(best_i)
        sum0, dist = best_sum, best_dist
    return data[chosen]


def _assign(data: torch.Tensor, centres: np.ndarray) -> np.ndarray:
    """Each sample's nearest centre, the first on a tie: on the samples'
    device, returned to the host."""
    c = torch.from_numpy(centres).to(data.device)
    d = torch.stack([_sq_dist(data, ck) for ck in c], 1)
    return torch.argmin(d, 1).cpu().numpy()


def kmeans(samples: torch.Tensor, K: int, rng: CvRNG) -> torch.Tensor:
    """``cv::kmeans(samples, K, labels, TermCriteria(MAX_ITER, 10, 0), 1,
    KMEANS_PP_CENTERS)`` of float32 [N, dims] samples; returns the int64
    labels [N] on the samples' device."""
    data = samples.to(torch.float32).contiguous()
    host = data.cpu().numpy()
    N = len(data)
    if not 0 < K <= N:
        raise ValueError(f"kmeans of {N} samples into {K} clusters")
    max_iter = 2 if K == 1 else MAX_ITER
    eps = float(np.finfo(_F32).eps) ** 2
    centres = labels = None
    it = 0
    while True:
        shift = np.inf if it == 0 else 0.0
        old = centres
        if it == 0:
            centres = _pp_centres(data, K, rng).cpu().numpy()
        else:
            sums = np.zeros((K, data.shape[1]), _F32)
            counts = np.bincount(labels, minlength=K)
            for k in range(K):
                if counts[k]:
                    sums[k] = np.add.accumulate(host[labels == k], axis=0,
                                                dtype=_F32)[-1]
            for k in range(K):
                if counts[k]:
                    continue
                # an empty cluster takes the farthest sample of the largest
                big = int(np.argmax(counts))      # the first of the largest
                base = sums[big] * (_F32(1) / _F32(counts[big]))
                idx = np.nonzero(labels == big)[0]
                d = _sq_dist(host[idx], base)
                far = idx[len(d) - 1 - int(np.argmax(d[::-1]))]  # the last
                counts[big] -= 1
                counts[k] += 1
                labels[far] = k
                sums[big] = sums[big] - host[far]
                sums[k] = sums[k] + host[far]
            centres = np.empty_like(sums)
            for k in range(K):
                centres[k] = sums[k] * (_F32(1) / _F32(counts[k]))
                # the float32 difference, squared and summed in double
                dist = 0.0
                for t in (centres[k] - old[k]).astype(np.float64):
                    dist += t * t
                shift = max(shift, dist)
        it += 1
        if it == max_iter or shift <= eps:
            return torch.from_numpy(labels.astype(np.int64)).to(data.device)
        labels = _assign(data, centres)
