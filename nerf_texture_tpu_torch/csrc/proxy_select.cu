// proxy_select.cu -- survivor selection for the proxy renderer,
// hand-written for Hopper (sm_90a).  Two kernels, one per TPU kernel of
// nerf_texture_tpu/ops/proxy_select.py:
//   select_cdf_kernel  replaces _select_cdf_kernel (proxy_select_cdf);
//   select_topk_kernel replaces _select_kernel     (proxy_select).
//
// select_cdf_kernel.  For each ray, from K proxy densities on a uniform
// grid over [t_lo, t_hi]:
//   - alpha-compositing weights w by an exclusive transmittance cumsum;
//   - their CDF, normalised by the total weight;
//   - cap stratified quantiles u = (c + 0.5) / cap placed by inverse CDF,
//     linear inside each bin;
//   - dt2[c] = t[c+1] - t[c] clamped to dt_clamp bin widths, the last
//     slot running to t_hi; valid = total > w_eps (whole rays).
//
// What bounds it on the card: memory traffic and launch latency, not
// arithmetic.  Per ray it reads 4 (K + 2) bytes and writes 9 cap bytes
// (two f32 rows and one bool row), and does ~60 flops per lane.
//
// Design: one warp per ray, lane k holds sample k (K <= 32), so every
// per-ray quantity lives in registers and nothing goes through shared
// memory.  The two prefix sums are warp scans over __shfl_up_sync in the
// Hillis-Steele association of the TPU kernel's _cumsum_lanes, so the
// three implementations round alike; the TPU kernel's lane-roll scan
// itself (pltpu.roll + iota mask) was not carried over.  The bin of
// each quantile is popc(ballot(cdf < u)) -- the count of CDF entries
// below u -- and its cdf and weight come to every lane by __shfl_sync.
// Lanes < cap write the outputs, one slot each.
//
// select_topk_kernel.  For each ray, from K proxy samples (ts, sig):
//   - the same weights w, zeroed where the span is <= 0;
//   - the cap-th largest weight kth, from cap rounds of (warp max, mask
//     the FIRST lane equal to it: __ballot_sync + __ffs), which matches
//     lax.top_k when weights repeat;
//   - candidates valid & w >= kth & w > w_eps; rank = popc of the
//     candidate ballot below the lane (t order); keep = rank < cap;
//   - skip_excl = scan(skip_sdt) - skip_sdt, the proxy optical depth of
//     the dropped samples before each lane (an inclusive scan minus the
//     lane, as the TPU kernel computes it, not a true exclusive scan:
//     the rounding follows that);
//   - kept lane l writes its own ts and skip_excl to slot rank[l];
//     slots past the kept count get 0 and valid2 = 0.
// Same bound and design as above: ~(8 K + 8) bytes read and 9 cap
// written per ray; one warp per ray, everything in registers, cap + 3
// rounds of warp collectives.  No shared memory, no atomics.
//
// Entry points: proxy_select_cdf_launch and proxy_select_launch (plain C,
// loaded through ctypes by nerf_texture_tpu_torch/ops/proxy_select.py).
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;                  // 8 warps = 8 rays a block
constexpr int kRaysPerBlock = kThreads / 32;

// Inclusive Hillis-Steele scan across the warp: x[l] += x[l - s] for
// s = 1, 2, 4, 8, 16.  Lanes >= K hold 0 and only feed lanes above them.
__device__ __forceinline__ float warp_scan(float x, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const float y = __shfl_up_sync(kFull, x, s);
    if (lane >= s) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
select_cdf_kernel(const float* __restrict__ sig,
                  const float* __restrict__ t_lo,
                  const float* __restrict__ t_hi,
                  float* __restrict__ ts2, float* __restrict__ dt2,
                  uint8_t* __restrict__ valid2, int n, int k, int cap,
                  float w_eps, float dt_clamp) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kRaysPerBlock + (threadIdx.x >> 5);
  if (ray >= n) return;                        // uniform across the warp

  const float tlo = t_lo[ray];
  const float thi = t_hi[ray];
  const float span = fmaxf(thi - tlo, 0.0f);
  const float dts = span / static_cast<float>(k);
  const bool in_k = lane < k;
  const float s = in_k ? sig[static_cast<size_t>(ray) * k + lane] : 0.0f;

  const float sdt = s * dts;
  const float cs = warp_scan(sdt, lane);
  const float trans = expf(-(cs - sdt));
  float w = trans * (1.0f - expf(-sdt));
  if (!(span > 0.0f) || !in_k) w = 0.0f;

  const float cw = warp_scan(w, lane);
  const float total = __shfl_sync(kFull, cw, k - 1);
  const bool valid = (span > 0.0f) && (total > w_eps);
  const float tot = fmaxf(total, 1e-12f);
  const float cdf = cw / tot;
  const unsigned kmask = (k == 32) ? kFull : ((1u << k) - 1u);

  float my_t = 0.0f, my_dt = 0.0f, t_prev = 0.0f;
  for (int c = 0; c < cap; ++c) {
    const float u = static_cast<float>((c + 0.5) / cap);
    const unsigned below = __ballot_sync(kFull, cdf < u) & kmask;
    const int b = min(__popc(below), k - 1);
    const float cdf_hi = __shfl_sync(kFull, cdf, b);
    const float w_bin = __shfl_sync(kFull, w, b);
    const float cdf_lo = cdf_hi - w_bin / tot;
    const float frac = fminf(
        fmaxf((u - cdf_lo) / fmaxf(cdf_hi - cdf_lo, 1e-12f), 0.0f), 1.0f);
    const float t_c = tlo + (static_cast<float>(b) + frac) * dts;
    if (lane == c) my_t = t_c;
    if (c > 0 && lane == c - 1) my_dt = fminf(t_c - t_prev, dt_clamp * dts);
    t_prev = t_c;
  }
  if (lane == cap - 1) my_dt = fminf(fmaxf(thi - t_prev, 0.0f), dt_clamp * dts);

  if (lane < cap) {
    const size_t o = static_cast<size_t>(ray) * cap + lane;
    ts2[o] = my_t;
    dt2[o] = my_dt;
    valid2[o] = valid ? 1 : 0;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__global__ void __launch_bounds__(kThreads)
select_topk_kernel(const float* __restrict__ ts,
                   const float* __restrict__ sig,
                   const float* __restrict__ t_lo,
                   const float* __restrict__ t_hi,
                   float* __restrict__ ts2, float* __restrict__ skip2,
                   uint8_t* __restrict__ valid2, int n, int k, int cap,
                   float w_eps) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kRaysPerBlock + (threadIdx.x >> 5);
  if (ray >= n) return;                        // uniform across the warp

  const float span = fmaxf(t_hi[ray] - t_lo[ray], 0.0f);
  const float dts = span / static_cast<float>(k);
  const bool valid = span > 0.0f;
  const bool in_k = lane < k;
  const size_t row = static_cast<size_t>(ray) * k + lane;
  const float s = in_k ? sig[row] : 0.0f;
  const float t = in_k ? ts[row] : 0.0f;

  const float sdt = in_k ? s * dts : 0.0f;
  const float cs = warp_scan(sdt, lane);
  float w = expf(-(cs - sdt)) * (1.0f - expf(-sdt));
  if (!valid) w = 0.0f;

  // lanes past K never win a round: -inf is below every masked lane (-1)
  float w_cur = in_k ? w : -CUDART_INF_F;
  float kth = 0.0f;
  for (int r = 0; r < cap; ++r) {
    kth = warp_max(w_cur);
    const unsigned eq = __ballot_sync(kFull, w_cur == kth);
    if (lane == __ffs(eq) - 1) w_cur = -1.0f;
  }

  const bool cand = in_k && valid && (w >= kth) && (w > w_eps);
  const unsigned cand_mask = __ballot_sync(kFull, cand);
  const int rank = __popc(cand_mask & ((1u << lane) - 1u));
  const bool keep = cand && rank < cap;
  const float skip_sdt = (keep || !valid) ? 0.0f : sdt;
  const float skip_excl = warp_scan(skip_sdt, lane) - skip_sdt;

  const size_t o = static_cast<size_t>(ray) * cap;
  if (keep) {
    ts2[o + rank] = t;
    skip2[o + rank] = skip_excl;
    valid2[o + rank] = 1;
  }
  const int kept = min(__popc(cand_mask), cap);
  if (lane >= kept && lane < cap) {
    ts2[o + lane] = 0.0f;
    skip2[o + lane] = 0.0f;
    valid2[o + lane] = 0;
  }
}

}  // namespace

extern "C" int proxy_select_launch(const void* ts, const void* sig,
                                   const void* t_lo, const void* t_hi,
                                   void* ts2, void* skip2, void* valid2,
                                   int n, int k, int cap, float w_eps,
                                   void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > 32 || cap < 1 || cap > k)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kRaysPerBlock - 1) / kRaysPerBlock);
  select_topk_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ts), static_cast<const float*>(sig),
      static_cast<const float*>(t_lo), static_cast<const float*>(t_hi),
      static_cast<float*>(ts2), static_cast<float*>(skip2),
      static_cast<uint8_t*>(valid2), n, k, cap, w_eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int proxy_select_cdf_launch(const void* sig, const void* t_lo,
                                       const void* t_hi, void* ts2,
                                       void* dt2, void* valid2, int n,
                                       int k, int cap, float w_eps,
                                       float dt_clamp, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > 32 || cap < 1 || cap > k)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kRaysPerBlock - 1) / kRaysPerBlock);
  select_cdf_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(t_lo),
      static_cast<const float*>(t_hi), static_cast<float*>(ts2),
      static_cast<float*>(dt2), static_cast<uint8_t*>(valid2), n, k, cap,
      w_eps, dt_clamp);
  return static_cast<int>(cudaGetLastError());
}
