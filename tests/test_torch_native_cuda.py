"""The grid-hash table kernels (``csrc/spatial_build.cu``) against their
plain versions on the card.

Marked ``cuda`` (skipped without a card); imports no JAX, so it also runs
where JAX is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_native_cuda.py``.  The binning kernels are held to the
plain float32 binning bit for bit; the kd-tree kernel bit for bit to
its plain version, cKDTree's query on the same tree (ties and their
order included), with a node heap small enough that rows overflow and
run again.  The inputs cover grids of res 8 to 64, empty cells, cells
over M items, triangles that span many cells, the clamp at the grid's
sides, fewer items than fallback slots, a lattice and the UV atlas's
duplicated seam vertices, which tie.
"""

import numpy as np
import pytest
import torch

from nerf_texture_tpu_torch import native
from nerf_texture_tpu_torch.geometry import spatial
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
from nerf_texture_tpu_torch.geometry.projector import uv_atlas


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _grid(points, res, pad=1e-3):
    lo = points.min(0) - pad
    return lo, float((points.max(0) + pad - lo).max() / res)


def _points(n, seed):
    """n seeded points in [-1, 1]^3 (two anchors at the corners): a uniform
    cloud over the half x < 0 (the other half's cells stay empty but
    for the cluster), a tight cluster (one cell holds hundreds) and
    points on cell faces of a res-16 grid, also in that half."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, (n, 3))
    p[:, 0] = -np.abs(p[:, 0])
    p[0], p[1] = -1.0, 1.0
    p[2: n // 8] = rng.normal(0.3, 1e-3, (n // 8 - 2, 3))
    lo, cs = _grid(p, 16)
    k = rng.integers(1, 8, (n // 8, 3))
    p[n // 8: n // 4] = lo + k * cs
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("res,M", [(8, 4), (16, 16), (37, 16), (64, 24)])
def test_vertex_kernel_matches_plain(cuda_device, res, M):
    p = _points(20000, res)
    lo, cs = _grid(p, res)
    if res == 37:                       # an origin that leaves points out
        lo, cs = lo + 0.2, cs * 0.8
    v = torch.as_tensor(p)
    native.build_vertex_grid.launches = 0
    got = native.build_vertex_grid(v.to(cuda_device), res, lo, cs, M)
    torch.cuda.synchronize()
    want = native.build_vertex_grid_reference(v, res, lo, cs, M)
    assert native.build_vertex_grid.launches == 1
    assert torch.equal(got.cpu(), want)
    full = (want >= 0).sum(1)
    assert (full == 0).any() and (full == M).any()   # empty and over-M cells


@pytest.mark.cuda
@pytest.mark.parametrize("res,M", [(8, 8), (32, 8), (64, 4), (64, 24)])
def test_triangle_kernel_matches_plain(cuda_device, res, M):
    m = make_icosphere(4, radius=0.5)
    rng = np.random.default_rng(res)
    verts = np.concatenate([m.vertices, rng.uniform(-0.6, 0.6, (30, 3))])
    big = len(m.vertices) + rng.integers(0, 30, (10, 3))   # span many cells
    faces = np.concatenate([m.faces, big])
    lo, cs = _grid(verts[faces].reshape(-1, 3), res)
    native.build_triangle_grid.launches = 0
    got = native.build_triangle_grid(
        torch.as_tensor(verts, device=cuda_device),
        torch.as_tensor(faces, device=cuda_device), res, lo, cs, M)
    torch.cuda.synchronize()
    want = native.build_triangle_grid_reference(
        torch.as_tensor(verts), torch.as_tensor(faces), res, lo, cs, M)
    assert native.build_triangle_grid.launches == 1
    assert torch.equal(got.cpu(), want)
    assert ((want >= 0).sum(1) == M).any() or M == 24   # cells over M


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mesh", "lattice", "atlas", "three",
                                  "one"])
def test_fallback_kernel_matches_plain(cuda_device, case):
    if case == "atlas":
        # the UV atlas duplicates its seam vertices: exact ties
        p = uv_atlas(make_icosphere(3, radius=0.5)).vertices
        res = 24
        lo, cs = _grid(p, res)
    elif case == "lattice":
        # the centres on lattice points: one item at 0, six at 1, twelve
        # at sqrt(2), so every row ties across its 8th slot
        r = np.arange(9, dtype=np.float64)
        p = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
        p = p[np.random.default_rng(0).permutation(len(p))]
        res, lo, cs = 8, np.full(3, -0.5), 1.0
    else:
        p = make_icosphere(4, radius=0.5).vertices
        p = p + np.random.default_rng(1).normal(0, 1e-3, p.shape)
        p = {"mesh": p, "three": p[:3], "one": p[:1]}[case]
        res = 32
        lo, cs = _grid(p, res)
    native.build_fallback.launches = 0
    got = native.build_fallback(native.kdtree(p, cuda_device), res, lo, cs, 8)
    torch.cuda.synchronize()
    assert native.build_fallback.launches == 1
    assert int(native.build_fallback.evaluations) > 0
    want = native.build_fallback(native.kdtree(p, "cpu"), res, lo, cs, 8)
    assert got.shape == want.shape == (res ** 3, 8)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_fallback_kernel_reruns_rows_that_outgrow_the_heap(cuda_device,
                                                           monkeypatch):
    """A node heap of 2 entries and 1,000 rows a launch: most rows of a
    sphere's grid overflow and run again with 8, 32, ... entries."""
    p = make_icosphere(3, radius=0.5).vertices
    res = 16
    lo, cs = _grid(p, res)
    monkeypatch.setattr(native, "KD_QMAX", 2)
    monkeypatch.setattr(native, "KD_ROWS", 1000)
    got = native.build_fallback(native.kdtree(p, cuda_device), res, lo, cs, 8)
    want = native.build_fallback(native.kdtree(p, "cpu"), res, lo, cs, 8)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_spatial_build_on_the_card_matches_the_cpu(cuda_device):
    m = make_icosphere(5, radius=0.5)
    for build in (
            lambda d: spatial.build_grid(m.vertices, 64, 16, device=d),
            lambda d: spatial.build_triangle_grid(m.vertices, m.faces, 64,
                                                  24, device=d)):
        a, b = build(cuda_device), build("cpu")
        assert a.cell_items.device.type == "cuda"
        for key in ("cell_items", "fallback", "origin", "cell_size"):
            assert torch.equal(getattr(a, key).cpu(), getattr(b, key)), key


@pytest.mark.cuda
def test_kernels_reject_what_they_cannot_take(cuda_device):
    p = torch.rand(20, 3, dtype=torch.float64)
    with pytest.raises(ValueError):
        native.build_triangle_grid(p.to(cuda_device),
                                   torch.zeros(1, 3, dtype=torch.int64),
                                   4, [0, 0, 0], 0.25, 4)
    with pytest.raises(ValueError):
        native.build_fallback(native.kdtree(p.numpy(), cuda_device), 4,
                              [0, 0, 0], 0.25, 9)
