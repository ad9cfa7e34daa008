"""Inverse-CDF survivor placement for the proxy renderer.

``proxy_select_cdf`` is the port of the TPU kernel
``nerf_texture_tpu/ops/proxy_select.py::proxy_select_cdf``: on a CUDA
tensor it launches the hand-written kernel ``csrc/proxy_select.cu``
(built at first use, see ``kernels.py``) or raises; on a CPU tensor it
runs ``proxy_select_cdf_reference``, the plain PyTorch version of the
same function, which is also the kernel's oracle on the card.

Both prefix sums use the Hillis-Steele association of the TPU kernel's
``_cumsum_lanes`` (``cumsum_lanes`` below, and a warp scan in the
kernel), so the TPU kernel, the CUDA kernel and the plain version round
alike.  The top-k selection kernel ``proxy_select`` (used only with
``infer_cdf=False``) is not ported yet.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..kernels import load_library

MAX_K = 32          # one warp per ray, one lane per proxy sample
DT_CLAMP = 2.0      # segment lengths are clamped to 2 proxy bin widths


def cumsum_lanes(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along the last axis, Hillis-Steele:
    log2(K) rounds of x[k] += x[k - s]."""
    K = x.shape[-1]
    s = 1
    while s < K:
        x = x + F.pad(x[..., :-s], (s, 0))
        s *= 2
    return x


def proxy_select_cdf_reference(ts, sig, t_lo, t_hi, *, cap: int,
                               w_eps: float):
    """Plain PyTorch ``proxy_select_cdf``: ``cap`` stratified quantiles of
    each ray's proxy weight distribution.

    ts [N, K] (unused but for its shape, as in the JAX function), sig
    [N, K], t_lo / t_hi [N], all f32.  Returns (ts2 [N, cap] f32,
    dt2 [N, cap] f32, valid2 [N, cap] bool)."""
    N, K = sig.shape
    span = torch.clamp(t_hi - t_lo, min=0.0)[:, None]         # [N, 1]
    dts = span / K
    sdt = sig * dts
    cs = cumsum_lanes(sdt)
    trans = torch.exp(-(cs - sdt))
    w = trans * (1.0 - torch.exp(-sdt))
    w = torch.where(span > 0.0, w, 0.0)                        # [N, K]

    cw = cumsum_lanes(w)
    total = cw[:, K - 1:]                                      # [N, 1]
    valid = (span > 0.0) & (total > w_eps)
    tot = torch.clamp(total, min=1e-12)
    cdf = cw / tot

    u = torch.tensor([(c + 0.5) / cap for c in range(cap)],
                     dtype=sig.dtype, device=sig.device)       # [cap]
    below = cdf[:, None, :] < u[None, :, None]                 # [N, cap, K]
    b = torch.clamp(below.sum(-1), max=K - 1)                  # [N, cap]
    cdf_hi = torch.gather(cdf, 1, b)
    w_bin = torch.gather(w, 1, b)
    cdf_lo = cdf_hi - w_bin / tot
    frac = torch.clamp((u - cdf_lo)
                       / torch.clamp(cdf_hi - cdf_lo, min=1e-12), 0.0, 1.0)
    ts2 = t_lo[:, None] + (b.to(sig.dtype) + frac) * dts       # [N, cap]

    clamp = DT_CLAMP * dts
    gaps = torch.minimum(ts2[:, 1:] - ts2[:, :-1], clamp)
    tail = torch.minimum(torch.clamp(t_hi[:, None] - ts2[:, -1:], min=0.0),
                         clamp)
    dt2 = torch.cat([gaps, tail], dim=1)
    return ts2, dt2, valid.expand(N, cap)


@functools.cache
def _launcher():
    fn = load_library("proxy_select").proxy_select_cdf_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def proxy_select_cdf(ts, sig, t_lo, t_hi, *, cap: int, w_eps: float):
    """Stratified inverse-CDF sample placement over the proxy weights.

    Same call as the JAX function (ts is unused but for its shape).  On
    the CPU this is ``proxy_select_cdf_reference``; on a CUDA tensor it
    launches ``csrc/proxy_select.cu`` and counts the launch in
    ``proxy_select_cdf.launches``, or raises on inputs the kernel does
    not take."""
    if sig.device.type == "cpu":
        return proxy_select_cdf_reference(ts, sig, t_lo, t_hi, cap=cap,
                                          w_eps=w_eps)
    if sig.device.type != "cuda":
        raise ValueError(f"proxy_select_cdf: no kernel for device "
                         f"{sig.device}")
    if sig.dim() != 2:
        raise ValueError(f"proxy_select_cdf: sig must be [N, K], got "
                         f"{tuple(sig.shape)}")
    N, K = sig.shape
    if K > MAX_K:
        raise ValueError(f"proxy_select_cdf: K={K} proxy samples exceed the "
                         f"CUDA kernel's limit of {MAX_K} (one warp lane "
                         f"per sample)")
    if not 1 <= cap <= K:
        raise ValueError(f"proxy_select_cdf: cap={cap} must be in [1, K={K}]")
    if tuple(ts.shape) != (N, K):
        raise ValueError(f"proxy_select_cdf: ts {tuple(ts.shape)} and sig "
                         f"{tuple(sig.shape)} differ")
    for name, t, shape in (("sig", sig, (N, K)), ("t_lo", t_lo, (N,)),
                           ("t_hi", t_hi, (N,))):
        if t.device != sig.device:
            raise ValueError(f"proxy_select_cdf: {name} on {t.device}, sig "
                             f"on {sig.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"proxy_select_cdf: {name} must be float32, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"proxy_select_cdf: {name} must have shape "
                             f"{shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"proxy_select_cdf: {name} must be contiguous")

    ts2 = torch.empty((N, cap), dtype=torch.float32, device=sig.device)
    dt2 = torch.empty_like(ts2)
    valid2 = torch.empty((N, cap), dtype=torch.bool, device=sig.device)
    if N == 0:
        return ts2, dt2, valid2
    launch = _launcher()
    with torch.cuda.device(sig.device):
        stream = torch.cuda.current_stream(sig.device).cuda_stream
        err = launch(sig.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr(),
                     ts2.data_ptr(), dt2.data_ptr(), valid2.data_ptr(),
                     N, K, cap, float(w_eps), DT_CLAMP, stream)
    if err != 0:
        raise RuntimeError(f"proxy_select_cdf: kernel launch failed with "
                           f"cudaError {err}")
    proxy_select_cdf.launches += 1
    return ts2, dt2, valid2


proxy_select_cdf.launches = 0
