"""Evaluation metrics (port of ``nerf_texture_tpu/utils/metrics.py``)."""

from __future__ import annotations

import numpy as np
import torch


def psnr(pred, gt) -> float:
    """Peak signal-to-noise ratio of [0, 1] images (tensors or arrays),
    computed on the host in f32; 99 dB when they are equal."""
    a, b = (x.detach().cpu().numpy() if torch.is_tensor(x) else x
            for x in (pred, gt))
    mse = float(np.mean((np.asarray(a, np.float32)
                         - np.asarray(b, np.float32)) ** 2))
    if mse <= 1e-12:
        return 99.0
    return -10.0 * float(np.log10(mse))


class PSNRMeter:
    """Running mean of ``psnr`` over ``update(pred, gt)`` calls."""

    def __init__(self):
        self.v = 0.0
        self.n = 0

    def update(self, pred, gt):
        self.v += psnr(pred, gt)
        self.n += 1

    @property
    def average(self) -> float:
        return self.v / max(self.n, 1)

    def clear(self):
        self.v, self.n = 0.0, 0
