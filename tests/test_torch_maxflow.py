"""The max-flow kernel (``csrc/maxflow.cu``) against its plain PyTorch
version on the card.

Marked ``cuda`` (skipped without a card); imports no JAX, so it also runs
where JAX is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_maxflow.py``.  The graphs are GrabCut-like: N-links of
gamma * exp(-beta d^2) over a random image, net terminal weights of
either sign with a band of hard labels (+-450), on grids whose sides fall
on and around the kernel's 32-node tiles (1, 31, 32, 33, 961); and
textured-background graphs (net weights from a smooth field plus noise)
whose cuts take hundreds of sweeps and many global relabels.

The kernel and the plain version run the same phases with the same
float64 arithmetic in the same order, so the cuts are expected to be
equal and the energies equal; the bounds are the smoke's (99.99% of the
pixels, energy within 1e-9 relative).  Two kernel runs agree bit for bit
(no float atomics).
"""

import numpy as np
import pytest
import torch

from nerf_texture_tpu_torch.ops import grabcut as gc
from nerf_texture_tpu_torch.ops import maxflow


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def grid_graph(H: int, W: int, seed: int):
    """(cap [8, H, W], weight [H, W]) float64 of a GrabCut-like graph."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    blob = ((yy - H / 2) ** 2 + (xx - W / 2) ** 2) < (0.3 * max(H, W)) ** 2
    img[blob] = np.clip(img[blob] // 4 + 160, 0, 255)
    t = torch.from_numpy(img)
    cap = gc.n_weights(t, gc.calc_beta(t))
    w = rng.normal(0, 30, (H, W)) + np.where(blob, 40.0, -40.0)
    w[:, :1] = -gc.LAMBDA
    if H > 2 and W > 2:
        w[H // 2, W // 2] = gc.LAMBDA
    return cap, torch.from_numpy(w)


def textured_graph(H: int, W: int, seed: int):
    """(cap [8, H, W], weight [H, W]) float64 of a cut over a textured
    background: net weights from a smooth field (period 128 nodes) plus
    noise, the left column hard background."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.integers(0, 256, (H, W, 3)).astype(np.uint8))
    yy, xx = np.mgrid[0:H, 0:W]
    w = (30 * np.sin(2 * np.pi * xx / 128) * np.sin(2 * np.pi * yy / 128)
         + rng.normal(0, 10, (H, W)))
    w[:, :1] = -gc.LAMBDA
    return gc.n_weights(t, gc.calc_beta(t)), torch.from_numpy(w)


@pytest.mark.cuda
@pytest.mark.parametrize("make,H,W", [
    (grid_graph, 1, 40), (grid_graph, 40, 1), (grid_graph, 31, 31),
    (grid_graph, 32, 32), (grid_graph, 33, 33), (grid_graph, 31, 961),
    (grid_graph, 33, 961), (grid_graph, 96, 96), (grid_graph, 270, 480),
    (textured_graph, 96, 96), (textured_graph, 270, 480)])
def test_kernel_matches_plain(cuda_device, make, H, W):
    cap, w = make(H, W, seed=H * 1000 + W)
    cap, w = cap.to(cuda_device), w.to(cuda_device)
    maxflow.min_cut.launches = 0
    got = maxflow.min_cut(cap, w)
    stats = dict(maxflow.min_cut.last_stats)
    again = maxflow.min_cut(cap, w)
    torch.cuda.synchronize()
    assert maxflow.min_cut.launches == 2
    ref, ref_stats = maxflow.min_cut_reference(cap, w)
    assert torch.equal(got, again)
    assert float((got == ref).float().mean()) >= 0.9999
    e_got = maxflow.cut_energy(cap, w, got)
    e_ref = maxflow.cut_energy(cap, w, ref)
    assert abs(e_got - e_ref) <= 1e-9 * abs(e_ref)
    assert stats == ref_stats
    if make is textured_graph:
        assert stats["relabels"] > 2    # past one sweep batch


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    cap, w = grid_graph(8, 8, seed=0)
    with pytest.raises(ValueError):
        maxflow.min_cut(cap.float().to(cuda_device),
                        w.float().to(cuda_device))
    with pytest.raises(ValueError):
        maxflow.min_cut(cap.to(cuda_device), w)
