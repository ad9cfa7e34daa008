"""Feature-clustering regulariser (port of
``nerf_texture_tpu/models/clustering.py``).

Per hash level, learnable cluster centres with a Student-t soft
assignment and a KL self-distillation loss that sharpens the hash
features toward discrete clusters, so that they can be reused as texture
patches.  The JAX function picks one random level from its key; here the
picked level is an argument (``level``), drawn by the caller, and only
that level's sweep runs.
"""

from __future__ import annotations

import torch


def init_cluster_centers(generator: torch.Generator, num_levels: int,
                         n_clusters: int = 4, hidden: int = 2,
                         std: float = 1e-4) -> torch.Tensor:
    """U(-std, std) centres [num_levels, n_clusters, hidden] on the
    generator's device."""
    u = torch.rand((num_levels, n_clusters, hidden), generator=generator,
                   device=generator.device)
    return u * (2.0 * std) - std


def soft_assignment(x: torch.Tensor, centers: torch.Tensor,
                    alpha: float = 1.0) -> torch.Tensor:
    """Student-t soft assignment of points x [n, h] to centres [k, h]:
    [n, k], rows summing to 1."""
    d2 = torch.sum((x[:, None, :] - centers[None]) ** 2, dim=-1)
    num = (1.0 / (1.0 + d2 / alpha)) ** ((alpha + 1.0) / 2.0)
    return num / torch.sum(num, dim=1, keepdim=True)


def clustering_loss_level(embeddings: torch.Tensor, centers: torch.Tensor,
                          alpha: float = 1.0) -> torch.Tensor:
    """KL(target || t) against the sharpened (and detached) target, as
    torch's KLDivLoss(reduction='mean'): the mean over all [n, k]
    elements of target * (log target - log t)."""
    t = soft_assignment(embeddings, centers, alpha)
    target = t ** 2 / torch.sum(t, dim=0, keepdim=True)
    target = (target / torch.sum(target, dim=1, keepdim=True)).detach()
    kl = target * (torch.log(torch.clamp(target, min=1e-12))
                   - torch.log(torch.clamp(t, min=1e-12)))
    return torch.mean(kl)


def clustering_loss(table: torch.Tensor, level_slices, centers: torch.Tensor,
                    level: int | None = None, alpha: float = 1.0,
                    level_dim: int = 2,
                    row_width: int | None = None) -> torch.Tensor:
    """Clustering loss of a packed hash table [rows, storage_width]: each
    row holds row_width / level_dim lattice entries of ``level_dim``
    channels; only the lanes [:, :row_width] are features (the rest are
    a dual table's log-variances or padding).  level_slices: the (start,
    end) rows of each level; centers [L, n_clusters, level_dim].

    ``level`` (an int, the JAX function's random pick) sweeps that level
    only; None sums every level, as the JAX function without a key."""
    width = row_width if row_width is not None else table.shape[1]

    def level_loss(lvl):
        start, end = level_slices[lvl]
        emb = table[start:end, :width].reshape(-1, level_dim)
        return clustering_loss_level(emb, centers[lvl], alpha)

    if level is not None:
        return level_loss(level)
    return sum(level_loss(lvl) for lvl in range(len(level_slices)))
