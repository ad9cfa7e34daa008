"""Survivor selection for the proxy renderer: [N, K] proxy densities ->
[N, cap] sample slots.

Ports of the two TPU kernels of ``nerf_texture_tpu/ops/proxy_select.py``:

- ``proxy_select_cdf``: stratified inverse-CDF placement of ``cap``
  quantiles (``infer_cdf=True``, the bench render);
- ``proxy_select``: the top-``cap`` samples by proxy weight, in t order,
  with the optical depth of the dropped samples (``infer_cdf=False``).

On a CUDA tensor each wrapper launches its hand-written kernel in
``csrc/proxy_select.cu`` (built at first use, see ``kernels.py``) and
counts the launch in its ``launches`` attribute, or raises; on a CPU
tensor it runs its ``*_reference`` twin, the plain PyTorch version of the
same function, which is also the kernel's oracle on the card.

Every prefix sum uses the Hillis-Steele association of the TPU kernels'
``_cumsum_lanes`` (``cumsum_lanes`` below, and the same passes over a
ray's registers in the kernels), so the TPU kernels, the CUDA kernels
and the plain versions round alike.

The kernels move whole tiles of ``TILE_RAYS`` rays with bulk copies,
which need 16-byte-aligned addresses: the wrappers raise on a tensor
whose data pointer is not (a fresh or cloned tensor always is).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..kernels import load_library

MAX_K = 32          # a ray's samples: 8 threads' registers, 4 a thread
DT_CLAMP = 2.0      # segment lengths are clamped to 2 proxy bin widths
TILE_RAYS = 32      # rays a kernel tile (kRays in csrc/proxy_select.cu)
ALIGN = 16          # bytes: the alignment the kernels' bulk copies need


def cumsum_lanes(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along the last axis, Hillis-Steele:
    log2(K) rounds of x[k] += x[k - s]."""
    K = x.shape[-1]
    s = 1
    while s < K:
        x = x + F.pad(x[..., :-s], (s, 0))
        s *= 2
    return x


def _per_sample(span: torch.Tensor, K: int) -> torch.Tensor:
    """span / K, rounded once.  The divisor is a tensor: on CUDA, PyTorch
    divides by a Python scalar as a multiply by its rounded reciprocal,
    which for a K that is not a power of two can differ from the
    quotient (that the JAX kernels and the CUDA kernels compute) in the
    last bit."""
    return span / torch.full_like(span, K)


def proxy_select_cdf_reference(ts, sig, t_lo, t_hi, *, cap: int,
                               w_eps: float):
    """Plain PyTorch ``proxy_select_cdf``: ``cap`` stratified quantiles of
    each ray's proxy weight distribution.

    ts [N, K] (unused but for its shape, as in the JAX function), sig
    [N, K], t_lo / t_hi [N], all f32.  Returns (ts2 [N, cap] f32,
    dt2 [N, cap] f32, valid2 [N, cap] bool)."""
    N, K = sig.shape
    span = torch.clamp(t_hi - t_lo, min=0.0)[:, None]         # [N, 1]
    dts = _per_sample(span, K)
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

    u = quantiles_reference(cap, sig.dtype, sig.device)       # [cap]
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


def quantiles_reference(cap: int, dtype: torch.dtype, device):
    """The plain version's stratified quantiles u = (c + 0.5) / cap,
    computed in double and rounded to ``dtype``."""
    return torch.tensor([(c + 0.5) / cap for c in range(cap)], dtype=dtype,
                        device=device)


def proxy_select_reference(ts, sig, t_lo, t_hi, *, cap: int,
                           w_eps: float):
    """Plain PyTorch ``proxy_select``: each ray's top-``cap`` proxy
    samples by weight, in t order.

    ts / sig [N, K], t_lo / t_hi [N], all f32.  The k-th largest weight
    comes from ``cap`` rounds of (max, mask its first occurrence), which
    matches ``lax.top_k`` when weights repeat; candidates at or above it
    and above ``w_eps`` are ranked in t order and capped at ``cap``.
    Returns (ts2 [N, cap] f32: the kept samples' ts; skip2 [N, cap] f32:
    the proxy optical depth of the dropped samples before each kept one;
    valid2 [N, cap] bool), with zeros in unfilled slots."""
    N, K = sig.shape
    span = torch.clamp(t_hi - t_lo, min=0.0)[:, None]         # [N, 1]
    dts = _per_sample(span, K)
    sdt = sig * dts
    cs = cumsum_lanes(sdt)
    trans = torch.exp(-(cs - sdt))
    w = trans * (1.0 - torch.exp(-sdt))
    w = torch.where(span > 0.0, w, 0.0)                        # [N, K]

    w_cur = w
    kth = torch.zeros_like(span)
    for _ in range(cap):
        kth = torch.amax(w_cur, dim=-1, keepdim=True)          # [N, 1]
        eq = (w_cur == kth).to(sig.dtype)
        first = (eq > 0.0) & (cumsum_lanes(eq) == 1.0)
        w_cur = torch.where(first, -1.0, w_cur)

    valid = span > 0.0                                         # [N, 1]
    cand = valid & (w >= kth) & (w > w_eps)
    candf = cand.to(sig.dtype)
    rank = cumsum_lanes(candf) - candf                         # 0-based
    keep = cand & (rank < cap)
    skip_sdt = torch.where(keep | ~valid, 0.0, sdt)
    skip_excl = cumsum_lanes(skip_sdt) - skip_sdt

    c = torch.arange(cap, dtype=sig.dtype, device=sig.device)
    slot = keep[:, None, :] & (rank[:, None, :] == c[None, :, None])
    ts2 = torch.sum(torch.where(slot, ts[:, None, :], 0.0), dim=-1)
    skip2 = torch.sum(torch.where(slot, skip_excl[:, None, :], 0.0), dim=-1)
    return ts2, skip2, torch.any(slot, dim=-1)


@functools.cache
def quantile_table(cap: int):
    """The CDF kernel's ``cap`` quantiles, a ctypes float array built once
    per cap: (c + 0.5) / cap in double, rounded to f32 as the plain
    version's ``quantiles_reference`` rounds it."""
    return (ctypes.c_float * cap)(*[(c + 0.5) / cap for c in range(cap)])


@functools.cache
def _launcher(name: str):
    """The C entry point ``name`` of csrc/proxy_select.cu with its
    argument types: tensor pointers, (for the CDF) the host quantile
    table, (n, k, cap), floats, the stream."""
    fn = getattr(load_library("proxy_select"), name)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = {
        "proxy_select_cdf_launch": [ptr] * 7 + [i32] * 3 + [f32] * 2 + [ptr],
        "proxy_select_launch": [ptr] * 7 + [i32] * 3 + [f32] + [ptr],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(fname: str, ts, sig, t_lo, t_hi, cap: int):
    """Raise on what the kernels do not take: a device other than CUDA,
    K > 32, cap outside [1, K], and a tensor of another device, dtype
    than f32, shape or layout.  Returns (N, K)."""
    if sig.device.type != "cuda":
        raise ValueError(f"{fname}: no kernel for device {sig.device}")
    if sig.dim() != 2:
        raise ValueError(f"{fname}: sig must be [N, K], got "
                         f"{tuple(sig.shape)}")
    N, K = sig.shape
    if K > MAX_K:
        raise ValueError(f"{fname}: K={K} proxy samples exceed the CUDA "
                         f"kernel's limit of {MAX_K} (4 samples a thread, "
                         f"8 threads a ray)")
    if not 1 <= cap <= K:
        raise ValueError(f"{fname}: cap={cap} must be in [1, K={K}]")
    for name, t, shape in (("ts", ts, (N, K)), ("sig", sig, (N, K)),
                           ("t_lo", t_lo, (N,)), ("t_hi", t_hi, (N,))):
        if t.device != sig.device:
            raise ValueError(f"{fname}: {name} on {t.device}, sig on "
                             f"{sig.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{fname}: {name} must be float32, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fname}: {name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fname}: {name} must be contiguous")
    return N, K


def _pointers(fname: str, named):
    """The data pointers of the (name, tensor) pairs; raise unless each is
    16-byte aligned, as the kernels' bulk copies need."""
    ptrs = []
    for name, t in named:
        ptr = t.data_ptr()
        if ptr % ALIGN:
            raise ValueError(f"{fname}: {name} is not {ALIGN}-byte aligned "
                             f"(data_ptr {ptr:#x}); the kernel's bulk "
                             f"copies need it (pass a fresh or cloned "
                             f"tensor)")
        ptrs.append(ptr)
    return ptrs


def _outputs(fname: str, N: int, cap: int, device):
    """Uninitialised [N, cap] (f32, f32, bool) outputs, which the kernels
    write in full, and their data pointers."""
    a = torch.empty((N, cap), dtype=torch.float32, device=device)
    outs = (a, torch.empty_like(a),
            torch.empty((N, cap), dtype=torch.bool, device=device))
    return outs, _pointers(fname, zip(("ts2", "out1", "valid2"), outs))


def _run(fname: str, launch, device, *args):
    """Launch on the current stream of ``device`` (entering it only when
    it is not the current device); raise on a refused launch (the C
    function returns cudaGetLastError()).  The stream's handle comes from
    torch's raw getter (the one Triton's launcher calls), which skips
    building a torch.cuda.Stream and its few microseconds a call."""
    if device.index == torch.cuda.current_device():
        err = launch(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = launch(*args,
                         torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{fname}: kernel launch failed with cudaError "
                           f"{err}")


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
    N, K = _check_kernel_inputs("proxy_select_cdf", ts, sig, t_lo, t_hi,
                                cap)
    p_sig, p_lo, p_hi = _pointers("proxy_select_cdf", (
        ("sig", sig), ("t_lo", t_lo), ("t_hi", t_hi)))
    outs, (p_ts2, p_dt2, p_v2) = _outputs("proxy_select_cdf", N, cap,
                                          sig.device)
    if N == 0:
        return outs
    _run("proxy_select_cdf", _launcher("proxy_select_cdf_launch"),
         sig.device, p_sig, p_lo, p_hi, p_ts2, p_dt2, p_v2,
         ctypes.addressof(quantile_table(cap)), N, K, cap, float(w_eps),
         DT_CLAMP)
    proxy_select_cdf.launches += 1
    return outs


proxy_select_cdf.launches = 0


def proxy_select(ts, sig, t_lo, t_hi, *, cap: int, w_eps: float):
    """Top-``cap`` survivor selection over the proxy weights.

    Same call as the JAX function.  On the CPU this is
    ``proxy_select_reference``; on a CUDA tensor it launches
    ``csrc/proxy_select.cu`` and counts the launch in
    ``proxy_select.launches``, or raises on inputs the kernel does not
    take.  Returns (ts2, skip2, valid2), each [N, cap], zero in unfilled
    slots."""
    if sig.device.type == "cpu":
        return proxy_select_reference(ts, sig, t_lo, t_hi, cap=cap,
                                      w_eps=w_eps)
    N, K = _check_kernel_inputs("proxy_select", ts, sig, t_lo, t_hi, cap)
    ptrs = _pointers("proxy_select", (("ts", ts), ("sig", sig),
                                      ("t_lo", t_lo), ("t_hi", t_hi)))
    outs, out_ptrs = _outputs("proxy_select", N, cap, sig.device)
    if N == 0:
        return outs
    _run("proxy_select", _launcher("proxy_select_launch"), sig.device,
         *ptrs, *out_ptrs, N, K, cap, float(w_eps))
    proxy_select.launches += 1
    return outs


proxy_select.launches = 0
