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
    cumsum_lanes, proxy_select, proxy_select_cdf, proxy_select_cdf_reference,
    proxy_select_reference)

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
