"""proxy_select_cdf and proxy_select in the PyTorch port vs the JAX package.

Each plain PyTorch version (the port's CPU path and the CUDA kernel's
oracle) is held against the JAX function, whose only implementation is
the Pallas kernel, run here in interpret mode (its CPU default).  The
CUDA kernels are held against the plain versions on the card by the tests
marked ``cuda``; they import no JAX, so they also run where JAX is not
installed (``python -m pytest --noconftest -m cuda
tests/test_torch_proxy_select.py``).

Tolerances: t values (ts2, dt2, skip2) within atol 1e-5 -- both sides use
the Hillis-Steele scan association, but the exp implementations and the
order of the total's sum differ in the last bits, and a quantile in a
low-weight bin amplifies that; valid2 exactly (test inputs keep every
ray's total weight away from w_eps).  The top-k selection copies the
kept samples' ts, so its ts2 only differs where the selection would.
"""

import numpy as np
import pytest
import torch

from nerf_texture_tpu_torch.ops.proxy_select import (
    TILE_RAYS, cumsum_lanes, proxy_select, proxy_select_cdf,
    proxy_select_cdf_reference, proxy_select_reference, quantile_table,
    quantiles_reference)

ATOL = 1e-5
W_EPS = 1e-4
CASES = [(64, 32, 8), (33, 16, 4), (130, 24, 4), (50, 20, 6)]
TOPK_CASES = [(64, 32, 8), (33, 16, 4), (128, 32, 8), (130, 24, 8)]


def _inputs(seed, N, K):
    """Seeded rays with degenerate spans, empty rays and exact ties."""
    rng = np.random.default_rng(seed)
    t_lo = rng.uniform(0.5, 1.5, N).astype(np.float32)
    t_hi = t_lo + rng.uniform(0.0, 1.0, N).astype(np.float32)
    t_hi[: N // 4] = t_lo[: N // 4]          # degenerate spans
    sig = rng.gamma(0.5, 4.0, (N, K)).astype(np.float32)
    sig[N // 4: N // 2] = 0.0                 # empty rays
    sig[N // 2: N // 2 + 4] = 3.0             # exact ties
    frac = (np.arange(K, dtype=np.float32) + 0.5) / K
    ts = t_lo[:, None] + np.maximum(t_hi - t_lo, 0.0)[:, None] * frac
    return ts, sig, t_lo, t_hi


def _total_weight(sig, t_lo, t_hi):
    K = sig.shape[1]
    span = np.maximum(t_hi - t_lo, 0.0)[:, None]
    sdt = sig.astype(np.float64) * span / K
    cs = np.cumsum(sdt, -1)
    return np.sum(np.exp(-(cs - sdt)) * (1.0 - np.exp(-sdt)), -1)


@pytest.mark.parametrize("seed,N,K,cap",
                         [(i,) + c for i, c in enumerate(CASES)])
def test_plain_matches_jax_pallas(seed, N, K, cap):
    import jax.numpy as jnp

    from nerf_texture_tpu.ops.proxy_select import (
        proxy_select_cdf as jax_select_cdf)

    ts, sig, t_lo, t_hi = _inputs(seed, N, K)
    tot = _total_weight(sig, t_lo, t_hi)
    assert np.all(np.abs(tot - W_EPS) > 1e-6)   # valid is well defined
    want = jax_select_cdf(jnp.asarray(ts), jnp.asarray(sig),
                          jnp.asarray(t_lo), jnp.asarray(t_hi), cap=cap,
                          w_eps=W_EPS)
    got = proxy_select_cdf(*(torch.from_numpy(a) for a in
                             (ts, sig, t_lo, t_hi)), cap=cap, w_eps=W_EPS)
    ts2, dt2, valid2 = (g.numpy() for g in got)
    assert ts2.shape == dt2.shape == valid2.shape == (N, cap)
    assert valid2.dtype == np.bool_
    np.testing.assert_array_equal(valid2, np.asarray(want[2]))
    np.testing.assert_allclose(ts2, np.asarray(want[0]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(dt2, np.asarray(want[1]), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed,N,K,cap",
                         [(i,) + c for i, c in enumerate(TOPK_CASES)])
def test_topk_plain_matches_jax_pallas(seed, N, K, cap):
    import jax.numpy as jnp

    from nerf_texture_tpu.ops.proxy_select import proxy_select as jax_select

    args = _inputs(seed, N, K)
    want = [np.asarray(a) for a in jax_select(
        *(jnp.asarray(a) for a in args), cap=cap, w_eps=W_EPS)]
    got = proxy_select(*(torch.from_numpy(a) for a in args), cap=cap,
                       w_eps=W_EPS)
    ts2, skip2, valid2 = (g.numpy() for g in got)
    assert ts2.shape == skip2.shape == valid2.shape == (N, cap)
    assert valid2.dtype == np.bool_
    assert valid2.any() and not valid2.all()
    np.testing.assert_array_equal(valid2, want[2])
    np.testing.assert_allclose(ts2, want[0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(skip2, want[1], rtol=0, atol=ATOL)
    assert not ts2[~valid2].any() and not skip2[~valid2].any()


def test_topk_keeps_heaviest_in_t_order():
    ts, sig, t_lo, t_hi = _inputs(3, 200, 24)
    ts2, skip2, valid2 = proxy_select_reference(
        *(torch.from_numpy(a) for a in (ts, sig, t_lo, t_hi)), cap=8,
        w_eps=W_EPS)
    assert not bool(valid2[:100].any())      # degenerate spans, empty rays
    kept = valid2.sum(-1)
    # slots fill from the front, in t order, with samples of the ray
    assert bool((valid2[:, 1:] <= valid2[:, :-1]).all())
    assert bool(((ts2[:, 1:] > ts2[:, :-1]) | ~valid2[:, 1:]).all())
    assert bool((kept[100:] == 8).any()) and bool((skip2 >= 0).all())
    row = 150
    n = int(kept[row])
    assert set(ts2[row, :n].tolist()) <= set(ts[row].tolist())


def test_cumsum_lanes_is_a_cumsum():
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (7, 24)).astype(np.float32))
    torch.testing.assert_close(cumsum_lanes(x), torch.cumsum(x, -1),
                               rtol=0, atol=1e-5)


def test_quantile_table_is_the_plain_versions_u():
    # the CDF kernel takes its quantiles from the wrapper's host table:
    # bit for bit the f32 values the plain version compares against
    for cap in range(1, 33):
        got = np.frombuffer(quantile_table(cap), dtype=np.float32)
        want = quantiles_reference(cap, torch.float32, "cpu").numpy()
        assert got.shape == want.shape == (cap,)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_quantiles_are_ordered_inside_span():
    ts, sig, t_lo, t_hi = _inputs(7, 200, 24)
    ts2, dt2, valid2 = proxy_select_cdf_reference(
        *(torch.from_numpy(a) for a in (ts, sig, t_lo, t_hi)), cap=4,
        w_eps=W_EPS)
    lo, hi = torch.from_numpy(t_lo)[:, None], torch.from_numpy(t_hi)[:, None]
    assert bool(((ts2 >= lo - 1e-6) & (ts2 <= hi + 1e-6)).all())
    assert bool((ts2[:, 1:] >= ts2[:, :-1] - 1e-6).all())
    assert bool((dt2 >= -1e-6).all())
    assert not bool(valid2[:50].any())       # degenerate spans
    assert not bool(valid2[50:100].any())    # empty rays


# ---------------------------------------------------------------------------
# CUDA kernel vs the plain version (card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
# full-width chunks: [16384, 24] cap 4 is the NGP render's, cap 5 the
# curved live render's
@pytest.mark.parametrize("seed,N,K,cap",
                         [(i,) + c for i, c in enumerate(
                             CASES + [(16384, 24, 4), (8192, 16, 5),
                                      (16384, 24, 5)])])
def test_kernel_matches_plain(cuda_device, seed, N, K, cap):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _inputs(seed, N, K)]
    before = proxy_select_cdf.launches
    got = proxy_select_cdf(*args, cap=cap, w_eps=W_EPS)
    want = proxy_select_cdf_reference(*args, cap=cap, w_eps=W_EPS)
    torch.cuda.synchronize()
    assert proxy_select_cdf.launches == before + 1
    assert got[2].dtype == torch.bool and got[2].shape == (N, cap)
    assert torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    sig = torch.ones((4, 40), device=cuda_device)
    t = torch.zeros(4, device=cuda_device)
    with pytest.raises(ValueError, match="limit of 32"):
        proxy_select_cdf(sig, sig, t, t + 1, cap=4, w_eps=W_EPS)
    sig = torch.ones((4, 24), device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        proxy_select_cdf(sig, sig, t.double(), t.double() + 1, cap=4,
                         w_eps=W_EPS)
    sig = torch.ones((24, 4), device=cuda_device).t()
    with pytest.raises(ValueError, match="contiguous"):
        proxy_select_cdf(sig, sig, t, t + 1, cap=4, w_eps=W_EPS)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,N,K,cap",
                         [(i,) + c for i, c in enumerate(
                             TOPK_CASES + [(16384, 24, 8), (8192, 32, 8),
                                           (8192, 16, 4)])])
def test_topk_kernel_matches_plain(cuda_device, seed, N, K, cap):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _inputs(seed, N, K)]
    before = proxy_select.launches
    got = proxy_select(*args, cap=cap, w_eps=W_EPS)
    want = proxy_select_reference(*args, cap=cap, w_eps=W_EPS)
    torch.cuda.synchronize()
    assert proxy_select.launches == before + 1
    assert got[2].dtype == torch.bool and got[2].shape == (N, cap)
    assert torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=ATOL)
    off = ~got[2]
    assert not bool(got[0][off].any()) and not bool(got[1][off].any())


@pytest.mark.cuda
def test_topk_kernel_rejects_what_it_cannot_take(cuda_device):
    sig = torch.ones((4, 40), device=cuda_device)
    t = torch.zeros(4, device=cuda_device)
    with pytest.raises(ValueError, match="limit of 32"):
        proxy_select(sig, sig, t, t + 1, cap=4, w_eps=W_EPS)
    sig = torch.ones((4, 24), device=cuda_device)
    with pytest.raises(ValueError, match="cap=25"):
        proxy_select(sig, sig, t, t + 1, cap=25, w_eps=W_EPS)
    with pytest.raises(ValueError, match="shape"):
        proxy_select(sig[:, :20].contiguous(), sig, t, t + 1, cap=4,
                     w_eps=W_EPS)


# Tile edges of the kernels: one ray, a tile less one, a tile and one, a
# full-width chunk plus a ragged tail, and four chunks plus a ragged tail
# (more tiles than the card holds blocks at once), over the K and cap the
# renders use.  A CDF slot in a bin holding little of the ray's weight is
# held in CDF space (see _cdf_slack).
EDGE_N = [1, TILE_RAYS - 1, TILE_RAYS + 1, 16384 + 3, 65536 + 3]
EDGE_KC = [(K, cap) for K in (16, 24, 32) for cap in (1, 4, 5, 8, K)]
CDF_ATOL = 1e-6


def _cdf_slack(args, ts2, valid2):
    """Per CDF slot, the t error that a CDF_ATOL error of the normalised
    CDF makes in the bin where the plain version put it: dts * CDF_ATOL /
    (the bin's share of the ray's weight), at most one bin width (16 ulps
    near 1 of the CDF; a quantile in a nearly empty bin amplifies a
    last-bit difference of the CDF into t)."""
    _, sig, t_lo, t_hi = args
    K = sig.shape[1]
    dts = torch.clamp(t_hi - t_lo, min=0.0)[:, None] / K
    sdt = sig * dts
    w = torch.exp(-(cumsum_lanes(sdt) - sdt)) * (1.0 - torch.exp(-sdt))
    share = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    b = torch.floor((ts2 - t_lo[:, None]) / torch.clamp(dts, min=1e-30))
    share = torch.gather(share, 1, torch.clamp(b.long(), 0, K - 1))
    slack = torch.minimum(dts * CDF_ATOL / torch.clamp(share, min=1e-12),
                          dts)
    return torch.where(valid2, slack, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("N", EDGE_N)
@pytest.mark.parametrize("K,cap", EDGE_KC)
def test_kernels_at_tile_edges(cuda_device, N, K, cap):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _inputs(N + K + cap, N, K)]
    for kernel, plain, cdf in ((proxy_select_cdf, proxy_select_cdf_reference,
                                True),
                               (proxy_select, proxy_select_reference, False)):
        before = kernel.launches
        got = kernel(*args, cap=cap, w_eps=W_EPS)
        want = plain(*args, cap=cap, w_eps=W_EPS)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert got[2].dtype == torch.bool and got[2].shape == (N, cap)
        assert torch.equal(got[2], want[2])
        slack = torch.full_like(want[0], ATOL)
        if cdf:
            slack = torch.maximum(slack, _cdf_slack(args, want[0], want[2]))
        # a gap dt2[c] moves with the slots at both of its ends
        slack1 = torch.maximum(slack, torch.cat([slack[:, 1:],
                                                 slack[:, -1:]], dim=1))
        assert bool(((got[0] - want[0]).abs() <= slack).all())
        assert bool(((got[1] - want[1]).abs() <= slack1).all())
        if not cdf:
            off = ~got[2]
            assert not bool(got[0][off].any())
            assert not bool(got[1][off].any())


@pytest.mark.cuda
# the baked curved render's chunks: K 16 cap 5 (the bench's baked frame)
# and K 20 cap 6 (its quality line; K 20 runs the K = 24 instantiation)
@pytest.mark.parametrize("seed,N,K,cap", [(40, 16384, 16, 5),
                                          (41, 16384, 20, 6)])
def test_kernel_matches_plain_at_the_baked_shapes(cuda_device, seed, N, K,
                                                  cap):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _inputs(seed, N, K)]
    before = proxy_select_cdf.launches
    got = proxy_select_cdf(*args, cap=cap, w_eps=W_EPS)
    want = proxy_select_cdf_reference(*args, cap=cap, w_eps=W_EPS)
    torch.cuda.synchronize()
    assert proxy_select_cdf.launches == before + 1
    assert torch.equal(got[2], want[2])
    slack = torch.maximum(torch.full_like(want[0], ATOL),
                          _cdf_slack(args, want[0], want[2]))
    slack1 = torch.maximum(slack, torch.cat([slack[:, 1:], slack[:, -1:]],
                                            dim=1))
    assert bool(((got[0] - want[0]).abs() <= slack).all())
    assert bool(((got[1] - want[1]).abs() <= slack1).all())


@pytest.mark.cuda
def test_kernels_reject_misaligned_tensors(cuda_device):
    N, K = 40, 24
    ts, sig, t_lo, t_hi = (torch.from_numpy(a).to(cuda_device)
                           for a in _inputs(0, N, K))
    # contiguous views 4 bytes past a 16-byte boundary
    sig_off = torch.zeros(N * K + 1, device=cuda_device)[1:].view(N, K)
    sig_off.copy_(sig)
    lo_off = torch.zeros(N + 1, device=cuda_device)[1:]
    lo_off.copy_(t_lo)
    for select in (proxy_select_cdf, proxy_select):
        before = select.launches
        with pytest.raises(ValueError, match="16-byte aligned"):
            select(ts, sig_off, t_lo, t_hi, cap=4, w_eps=W_EPS)
        with pytest.raises(ValueError, match="16-byte aligned"):
            select(ts, sig, lo_off, t_hi, cap=4, w_eps=W_EPS)
        assert select.launches == before
        # the same values from aligned tensors launch
        select(ts, sig_off.clone(), lo_off.clone(), t_hi, cap=4,
               w_eps=W_EPS)
        assert select.launches == before + 1
    # the CDF kernel does not read ts, so a misaligned ts launches
    ts_off = torch.zeros(N * K + 1, device=cuda_device)[1:].view(N, K)
    ts_off.copy_(ts)
    before = proxy_select_cdf.launches
    proxy_select_cdf(ts_off, sig, t_lo, t_hi, cap=4, w_eps=W_EPS)
    assert proxy_select_cdf.launches == before + 1
    with pytest.raises(ValueError, match="16-byte aligned"):
        proxy_select(ts_off, sig, t_lo, t_hi, cap=4, w_eps=W_EPS)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [200, 16384])
def test_two_round_render_through_the_kernel_equals_plain(cuda_device,
                                                          n_rays):
    """The two-round proxy (proxy_samples=32, the default RenderConfig):
    round 2 through the CUDA ``proxy_select`` equals the plain chain bit
    for bit, and launches once."""
    from nerf_texture_tpu_torch.render import renderer as rr

    H, r0 = 32, 0.5
    c = (torch.arange(H, dtype=torch.float32) + 0.5) / H * 2.0 - 1.0
    r = torch.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                   + c[None, None, :] ** 2)
    dens = (60.0 * torch.exp(-((r - r0) / 0.06) ** 2)).reshape(1, -1)
    dens8 = rr.density_corner_table(dens.to(cuda_device), H)
    g = torch.Generator().manual_seed(n_rays)
    d = torch.randn((n_rays, 3), generator=g) * torch.tensor(
        [0.25, 0.25, 0.0]) + torch.tensor([0.0, 0.0, 1.0])
    d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).to(cuda_device)
    o = torch.tensor([[0.05, -0.02, -2.0]], device=cuda_device).expand(
        n_rays, 3).contiguous()
    aabb = torch.tensor([-0.6] * 3 + [0.6] * 3, device=cuda_device)
    from nerf_texture_tpu_torch.ops.marching import near_far_from_aabb
    nears, fars = near_far_from_aabb(o, d, aabb, 0.2)
    cfg = rr.RenderConfig(grid_size=H)
    assert cfg.proxy_samples == 32 and cfg.infer_color_cap == 8

    def field(x, dirs):
        rr_ = torch.linalg.norm(x, dim=-1)
        return (60.0 * torch.exp(-((rr_ - r0) / 0.06) ** 2),
                (x / torch.clamp(rr_[..., None], min=1e-6) + 1.0) / 2.0)

    before = proxy_select.launches
    got = rr.render_rays_proxy(field, dens8, o, d, nears, fars, cfg)
    torch.cuda.synchronize()
    assert proxy_select.launches == before + 1
    want = rr.render_rays_proxy(field, dens8, o, d, nears, fars, cfg,
                                plain_select=True)
    assert proxy_select.launches == before + 1
    assert float(want["weights_sum"].max()) > 0.9
    for k in ("image", "depth", "weights_sum", "counts"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_shape_and_unhash_frames_through_the_kernel_equal_plain(
        cuda_device):
    """The imports onto another mesh on the card: a flat canvas wrapped
    onto a rounded box (``load_shape``, mode 'shape') and the trained
    field baked into the subdivided template (``unhash``), each rendered
    through the CUDA ``proxy_select_cdf`` (one launch a chunk), equal
    their plain-selection frames bit for bit."""
    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
    from nerf_texture_tpu_torch.geometry import mesh as tmesh
    from nerf_texture_tpu_torch.geometry import shape_tools as tst
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import curved_field as tcf
    from nerf_texture_tpu_torch.models import mesh_field as tmf
    from nerf_texture_tpu_torch.render.renderer import RenderConfig
    from nerf_texture_tpu_torch.train import curved_trainer as tct
    from nerf_texture_tpu_torch.train import field_io as tio

    fcfg = tmf.MeshFieldConfig(num_levels=3, level_dim=2, base_resolution=16,
                               desired_resolution=32, log2_bricks=9,
                               h_threshold=0.12, clustering=False)
    ccfg = tcf.CurvedFieldConfig(field=fcfg, light_model="SH", hidden_dim=16,
                                 geo_feat_dim=7)
    rcfg = RenderConfig(bound=1.0, cascades=1, grid_size=32, ray_chunk=1024,
                        proxy_samples=0)
    tr = tct.CurvedTrainer(
        SyntheticSphereDataset(n_frames=2, H=64, W=64),
        tmf.make_state(MeshProjector(tmesh.make_icosphere(2, 0.5),
                                     device=cuda_device)),
        ccfg, rcfg, tct.CurvedTrainConfig(), device=cuda_device)
    field = tr.state.params["field"]
    with torch.no_grad():                    # features that vary
        field["encoder"][:, :fcfg.feature_spec.row_width] *= 1e4
        field["normal"]["phi_grid"] *= 1e3
    rng = np.random.default_rng(0)
    S = 16
    tr.field_state = tr.field_state._replace(
        imported=tmf.import_field_data(
            features=np.cumsum(rng.normal(size=(S, S, 6)), 0) / S,
            sample_tbn=np.eye(3).reshape(1, 9), sample_tbn_ids=np.zeros(
                (S, S), np.int64),
            local_tbn=np.broadcast_to(np.eye(3).reshape(9), (S, S, 9)),
            phi_embed=rng.uniform(size=(S, S, fcfg.normal_cfg.phi_embed_dim)),
            bounds=[0.4, 0.4], device=cuda_device))
    pose = orbit_pose(1.1, 0.6, 2.0)
    for load in (lambda: tio.load_shape(tr, tst.laplacian_smooth(
            tst.subdivide_to(tmesh.make_box((0.5, 0.35, 0.25)), 300), 4)),
                 lambda: tio.unhash(tr, min_vertices=600)):
        load()
        before = proxy_select_cdf.launches
        got = tr.render_frame(pose, use_ema=False)
        assert proxy_select_cdf.launches - before == got["chunks"] > 0
        want = tr.render_frame(pose, use_ema=False, plain_select=True)
        assert proxy_select_cdf.launches - before == got["chunks"]
        assert float(want["weights_sum"].max()) > 0.5
        for k in ("image", "depth", "weights_sum"):
            assert torch.equal(got[k], want[k]), (tr.mode, k)
