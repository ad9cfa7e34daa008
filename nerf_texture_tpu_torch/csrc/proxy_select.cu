// proxy_select.cu -- survivor selection for the proxy renderer,
// hand-written for Hopper (sm_90a).  Two kernels, one per TPU kernel of
// nerf_texture_tpu/ops/proxy_select.py:
//   select_kernel<KP, false> (CDF)   replaces _select_cdf_kernel
//                                    (proxy_select_cdf);
//   select_kernel<KP, true>  (top-k) replaces _select_kernel (proxy_select).
//
// CDF.  For each ray, from K proxy densities on a uniform grid over
// [t_lo, t_hi]:
//   - alpha-compositing weights w by an exclusive transmittance cumsum;
//   - their CDF, normalised by the total weight;
//   - cap stratified quantiles u = (c + 0.5) / cap placed by inverse CDF,
//     linear inside each bin;
//   - dt2[c] = t[c+1] - t[c] clamped to dt_clamp bin widths, the last
//     slot running to t_hi; valid = total > w_eps (whole rays).
// Top-k.  For each ray, from K proxy samples (ts, sig):
//   - the same weights w, zeroed where the span is <= 0;
//   - the cap-th largest weight kth, from cap rounds of (max, mask its
//     FIRST occurrence), which matches lax.top_k when weights repeat;
//   - candidates valid & w >= kth & w > w_eps, ranked in t order and
//     kept while rank < cap;
//   - skip_excl = scan(skip_sdt) - skip_sdt, the proxy optical depth of
//     the dropped samples before each sample (an inclusive scan minus the
//     sample, as the TPU kernel computes it, not a true exclusive scan);
//   - kept sample k fills slot rank[k]; slots past the kept count get 0.
//
// Bound on the card.  Both are memory-bound: per ray the CDF reads
// 4 K + 8 bytes (sig, t_lo, t_hi) and writes 9 cap (two f32 rows, one
// bool row); top-k reads 8 K + 8 (ts too).  At the render's chunk,
// [16384, 24]: 2,441,216 bytes at cap 5 and 4,456,448 at cap 8, 0.73 us
// and 1.33 us at 3.35 TB/s.  The arithmetic, ~2 expf, one divide and a
// few dozen adds and compares a sample, is a fraction of that on the
// FP32 pipes.  There is no product anywhere, so tensor cores (wgmma)
// have nothing to do: the levers are bytes in flight, busy lanes and
// whole-sector stores.
//
// Design.
//   - Tiles of kRays = 32 rays.  A ray is a segment of kSeg = 8 threads
//     of a warp (4 rays a warp, 8 warps a block); thread j of the segment
//     holds samples j E .. j E + E - 1, E = KP / 8 with KP = K rounded up
//     to 8 (a template).  At K = 24 every lane holds three samples: no
//     lane idles, and a [16384, 24] chunk is 4,096 warps, enough to hide
//     latency on 132 SMs.  The [32, K] rows of a tile are 128 K
//     contiguous bytes.
//   - Each tile's rows of sig (and ts), t_lo and t_hi arrive in shared
//     memory by 1-D bulk copies (cp.async.bulk, TMA) that complete on an
//     mbarrier; one thread issues them.  A copy moves whole 16-byte
//     units, so the ragged last tile's last < 16 bytes of each array are
//     read by plain loads.
//   - One tile a block, one stage: a bulk load, the compute, a bulk
//     store.  A [16384, K] chunk is 512 tiles of 8 warps, all resident
//     at once on 132 SMs, so a persistent grid walking tiles through a
//     ring of stages would never reach a second tile at the render's
//     chunk; the chunk's parallelism comes from 8 threads a ray.
//   - Prefix sums are the Hillis-Steele passes x[l] += x[l - s], s = 1,
//     2, 4, 8, 16, each from the previous pass's values, over the
//     segment's samples (a source in another thread comes by
//     __shfl_up_sync).  That is the association of the TPU kernel's
//     _cumsum_lanes and of the plain version's cumsum_lanes: samples >= K
//     hold 0 and feed only samples above them, so the sums below K are
//     bit for bit those of a K-lane scan.  With --fmad=false, expf and
//     the plain version's clamps, the kernels round as the plain
//     versions do.
//   - The CDF's segment writes the ray's CDF and weights to a row of
//     shared memory; thread c % 8 places quantile c: it counts the CDF
//     entries below u over the row's K samples (a count, not a search: a
//     Hillis-Steele CDF need not be monotone in its last bit) and reads
//     the bin's CDF and weight back.  Top-k's rounds are
//     a segment max and a segment min over the index of its first
//     occurrence; ranks an exclusive count over the segment.
//   - The quantiles u come from the host, f32 values of (c + 0.5) / cap
//     as the plain version computes them; nothing here is double.
//   - Outputs are staged in shared memory and leave as bulk copies of
//     whole [32, cap] tiles of ts2, dt2 / skip2 and valid2 (contiguous in
//     the [N, cap] outputs), again with plain stores for the ragged
//     tail.
//   - Every global address a bulk copy touches is 16-byte aligned: the
//     wrapper checks each tensor's data pointer, and a tile starts at
//     row 32 t, i.e. at byte 128 t K of an [N, K] f32 input, 128 t cap
//     of an f32 output and 32 t cap of valid2.
//
// Entry points: proxy_select_cdf_launch and proxy_select_launch (plain C,
// loaded through ctypes by nerf_texture_tpu_torch/ops/proxy_select.py).
// Each launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (or cudaErrorInvalidValue /
// cudaErrorMisalignedAddress for inputs it does not take).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRays = 32;          // rays a tile
constexpr int kSeg = 8;            // threads a ray: a segment of a warp
constexpr int kThreads = kRays * kSeg;
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* ts;                 // top-k only
  const float* sig;
  const float* t_lo;
  const float* t_hi;
  float* out0;                     // ts2
  float* out1;                     // dt2 (CDF) or skip2 (top-k)
  uint8_t* valid2;
  int n, k, cap;
  float w_eps, dt_clamp;
};

struct Quantiles {
  float u[kMaxK];
};

__host__ __device__ constexpr uint32_t align16(uint32_t x) {
  return (x + 15u) & ~15u;
}

// Byte offsets in a block's dynamic shared memory, on host and device:
// the inputs [sig | ts (top-k) | t_lo | t_hi], the outputs [out0 | out1 |
// valid2], (CDF) a [kRays, KP + 4] row each of CDF values and weights,
// the mbarrier.
struct Layout {
  uint32_t in_rows, in_t, out_rows, out_valid;
  uint32_t row, out0, scr0, bar0, total;
};

__host__ __device__ inline Layout make_layout(int k, int cap, bool topk) {
  Layout L;
  L.row = (k + kSeg - 1) / kSeg * kSeg + 4;  // floats: KP + 4, 16-byte rows
  L.in_rows = align16(kRays * k * 4);
  L.in_t = align16(kRays * 4);
  L.out_rows = align16(kRays * cap * 4);
  L.out_valid = align16(kRays * cap);
  L.out0 = (topk ? 2u : 1u) * L.in_rows + 2u * L.in_t;
  L.scr0 = L.out0 + 2u * L.out_rows + L.out_valid;
  L.bar0 = L.scr0 + (topk ? 0u : 2u * kRays * L.row * 4u);
  L.total = L.bar0 + 8u;
  return L;
}

// ---- TMA bulk copies and mbarriers (PTX) --------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the bulk stores have read shared memory (before the block exits)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// generic-proxy writes to shared memory -> visible to the bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- one tile's movement ------------------------------------------------

// Input pointers of a tile in shared memory.
struct InStage {
  float* sig;
  float* ts;
  float* lo;
  float* hi;
};

template <bool kTopK>
__device__ __forceinline__ InStage in_stage(unsigned char* base,
                                            const Layout& L) {
  InStage s;
  s.sig = reinterpret_cast<float*>(base);
  s.ts = reinterpret_cast<float*>(base + L.in_rows);      // top-k only
  const uint32_t t0 = (kTopK ? 2u : 1u) * L.in_rows;
  s.lo = reinterpret_cast<float*>(base + t0);
  s.hi = reinterpret_cast<float*>(base + t0 + L.in_t);
  return s;
}

// One thread: bulk-copy the whole 16-byte units of the tile's inputs.
template <bool kTopK>
__device__ __forceinline__ void issue_tile(const Params& p, const Layout& L,
                                           unsigned char* base,
                                           uint64_t* bar, int row0) {
  const InStage s = in_stage<kTopK>(base, L);
  const int rows = min(kRays, p.n - row0);
  const uint32_t rows_b = static_cast<uint32_t>(rows * p.k * 4) & ~15u;
  const uint32_t t_b = static_cast<uint32_t>(rows * 4) & ~15u;
  mbar_arrive_expect_tx(bar, (kTopK ? 2u : 1u) * rows_b + 2u * t_b);
  const size_t off = static_cast<size_t>(row0) * p.k;
  if (rows_b) {
    bulk_load(s.sig, p.sig + off, rows_b, bar);
    if (kTopK) bulk_load(s.ts, p.ts + off, rows_b, bar);
  }
  if (t_b) {
    bulk_load(s.lo, p.t_lo + row0, t_b, bar);
    bulk_load(s.hi, p.t_hi + row0, t_b, bar);
  }
}

// All threads: the ragged tile's bytes past its last whole 16-byte unit.
template <bool kTopK>
__device__ __forceinline__ void load_tails(const Params& p, const InStage& s,
                                           int row0, int rows, int tid) {
  const int nf = rows * p.k;
  const size_t off = static_cast<size_t>(row0) * p.k;
  for (int i = (nf & ~3) + tid; i < nf; i += kThreads) {
    s.sig[i] = p.sig[off + i];
    if (kTopK) s.ts[i] = p.ts[off + i];
  }
  for (int i = (rows & ~3) + tid; i < rows; i += kThreads) {
    s.lo[i] = p.t_lo[row0 + i];
    s.hi[i] = p.t_hi[row0 + i];
  }
}

// One thread: bulk-copy the tile's staged outputs out, whole units only.
__device__ __forceinline__ void store_tile(const Params& p, const Layout& L,
                                           unsigned char* out, int row0,
                                           int rows) {
  const size_t off = static_cast<size_t>(row0) * p.cap;
  const uint32_t f_b = static_cast<uint32_t>(rows * p.cap * 4) & ~15u;
  const uint32_t v_b = static_cast<uint32_t>(rows * p.cap) & ~15u;
  if (f_b) {
    bulk_store(p.out0 + off, out, f_b);
    bulk_store(p.out1 + off, out + L.out_rows, f_b);
  }
  if (v_b) bulk_store(p.valid2 + off, out + 2 * L.out_rows, v_b);
  bulk_commit();
}

// All threads: the ragged tile's outputs past the last whole unit.
__device__ __forceinline__ void store_tails(const Params& p, const Layout& L,
                                            const unsigned char* out,
                                            int row0, int rows, int tid) {
  const size_t off = static_cast<size_t>(row0) * p.cap;
  const int nf = rows * p.cap;
  const float* o0 = reinterpret_cast<const float*>(out);
  const float* o1 = reinterpret_cast<const float*>(out + L.out_rows);
  const uint8_t* ov = out + 2 * L.out_rows;
  for (int i = (nf & ~3) + tid; i < nf; i += kThreads) {
    p.out0[off + i] = o0[i];
    p.out1[off + i] = o1[i];
  }
  for (int i = (nf & ~15) + tid; i < nf; i += kThreads)
    p.valid2[off + i] = ov[i];
}

// ---- per-ray arithmetic, one ray a segment of kSeg threads ---------------

// Thread j of a ray's segment holds samples j E .. j E + E - 1 (E = KP /
// kSeg); samples >= K read as 0.
template <int E>
__device__ __forceinline__ void load_slice(const float* row, int k, int j,
                                           bool live, float (&x)[E]) {
  if (live && k == E * kSeg) {            // row r at byte 4 K r: aligned
    const float* src = row + j * E;
    if constexpr (E % 4 == 0) {
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 v = *reinterpret_cast<const float4*>(src + e);
        x[e] = v.x;
        x[e + 1] = v.y;
        x[e + 2] = v.z;
        x[e + 3] = v.w;
      }
    } else if constexpr (E % 2 == 0) {
#pragma unroll
      for (int e = 0; e < E; e += 2) {
        const float2 v = *reinterpret_cast<const float2*>(src + e);
        x[e] = v.x;
        x[e + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = src[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      x[e] = (live && j * E + e < k) ? row[j * E + e] : 0.0f;
  }
}

// Inclusive Hillis-Steele scan over the segment's KP samples: pass S adds
// sample l - S to sample l (l >= S), all from the previous pass's values;
// a source in another thread comes by __shfl_up_sync within the segment.
// One pass a template level, so every index is a constant.
template <int E, int S = 1>
__device__ __forceinline__ void seg_scan(float (&x)[E], int j) {
  if constexpr (S < E * kSeg) {
    float src[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = S > e ? (S - e + E - 1) / E : 0;   // threads back
      const int es = e - S + d * E;                     // element there
      src[e] = d == 0 ? x[es] : __shfl_up_sync(kFull, x[es], d, kSeg);
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (j * E + e >= S) x[e] += src[e];
    seg_scan<E, 2 * S>(x, j);
  }
}

// sdt = sig * dts and the weights w of the thread's samples (both 0 past
// K; w also 0 where the ray is not live).
template <int E>
__device__ __forceinline__ void weights(const float (&x)[E], int k, int j,
                                        float dts, bool live,
                                        float (&sdt)[E], float (&w)[E]) {
  float cs[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    sdt[e] = j * E + e < k ? x[e] * dts : 0.0f;
    cs[e] = sdt[e];
  }
  seg_scan<E>(cs, j);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float we = expf(-(cs[e] - sdt[e])) * (1.0f - expf(-sdt[e]));
    w[e] = (live && j * E + e < k) ? we : 0.0f;
  }
}

template <typename T, typename Op>
__device__ __forceinline__ T seg_reduce(T v, Op op) {
#pragma unroll
  for (int o = 1; o < kSeg; o <<= 1) v = op(v, __shfl_xor_sync(kFull, v, o,
                                                               kSeg));
  return v;
}

// CDF: ts2, dt2, valid2 of a ray into its staged output rows.  The
// segment stages the ray's running weight sums, then its CDF (rcdf) and
// weights (rw) in shared memory; quantile c runs on thread c % kSeg.
template <int E>
__device__ __forceinline__ void cdf_ray(const Params& p, const Quantiles& q,
                                        const float* srow, float tlo,
                                        float thi, int j, bool live,
                                        float* rcdf, float* rw, float* o_t,
                                        float* o_dt, uint8_t* o_v) {
  constexpr int KP = E * kSeg;
  const int k = p.k, cap = p.cap;
  float x[E], sdt[E], w[E];
  load_slice<E>(srow, k, j, live, x);
  const float span = fmaxf(thi - tlo, 0.0f);
  const float dts = span / static_cast<float>(k);
  weights<E>(x, k, j, dts, span > 0.0f, sdt, w);

  float cw[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    cw[e] = w[e];
    rw[j * E + e] = w[e];
  }
  seg_scan<E>(cw, j);
#pragma unroll
  for (int e = 0; e < E; ++e) rcdf[j * E + e] = cw[e];
  __syncwarp();
  const float total = rcdf[k - 1];
  __syncwarp();                          // read before the row is rewritten
  const bool valid = (span > 0.0f) && (total > p.w_eps);
  const float tot = fmaxf(total, 1e-12f);
#pragma unroll
  for (int e = 0; e < E; ++e) rcdf[j * E + e] = cw[e] / tot;
  __syncwarp();

  const float clamp = p.dt_clamp * dts;
  if (live) {
    const float4* r4 = reinterpret_cast<const float4*>(rcdf);
    for (int c = j; c < cap; c += kSeg) {
      const float u = q.u[c];
      int cnt = 0;
#pragma unroll
      for (int l = 0; l < KP; l += 4) {
        const float4 v = r4[l / 4];
        cnt += (l < k && v.x < u) ? 1 : 0;
        cnt += (l + 1 < k && v.y < u) ? 1 : 0;
        cnt += (l + 2 < k && v.z < u) ? 1 : 0;
        cnt += (l + 3 < k && v.w < u) ? 1 : 0;
      }
      const int b = min(cnt, k - 1);
      const float hi = rcdf[b];
      const float cdf_lo = hi - rw[b] / tot;
      const float frac = fminf(
          fmaxf((u - cdf_lo) / fmaxf(hi - cdf_lo, 1e-12f), 0.0f), 1.0f);
      o_t[c] = tlo + (static_cast<float>(b) + frac) * dts;
      o_v[c] = valid ? 1 : 0;
    }
  }
  __syncwarp();                          // the segment's o_t rows are written
  if (live) {
    for (int c = j; c < cap; c += kSeg)
      o_dt[c] = c + 1 < cap ? fminf(o_t[c + 1] - o_t[c], clamp)
                            : fminf(fmaxf(thi - o_t[c], 0.0f), clamp);
  }
}

// Top-k: ts2, skip2, valid2 of a ray into its staged output rows.
template <int E>
__device__ __forceinline__ void topk_ray(const Params& p, const float* srow_ts,
                                         const float* srow_sig, float tlo,
                                         float thi, int j, bool live,
                                         float* o_t, float* o_s,
                                         uint8_t* o_v) {
  const int k = p.k, cap = p.cap;
  float x[E], t[E], sdt[E], w[E];
  load_slice<E>(srow_sig, k, j, live, x);
  load_slice<E>(srow_ts, k, j, live, t);
  const float span = fmaxf(thi - tlo, 0.0f);
  const float dts = span / static_cast<float>(k);
  const bool valid = span > 0.0f;
  weights<E>(x, k, j, dts, valid, sdt, w);

  // kth: cap rounds of (segment max, mask its FIRST occurrence with -1);
  // samples past K are -inf and never win
  float cur[E];
#pragma unroll
  for (int e = 0; e < E; ++e) cur[e] = j * E + e < k ? w[e] : -CUDART_INF_F;
  float kth = 0.0f;
  for (int r = 0; r < cap; ++r) {
    float m = cur[0];
#pragma unroll
    for (int e = 1; e < E; ++e) m = fmaxf(m, cur[e]);
    m = seg_reduce(m, [](float a, float o) { return fmaxf(a, o); });
    int first = E * kSeg;
#pragma unroll
    for (int e = E - 1; e >= 0; --e)
      if (cur[e] == m) first = j * E + e;
    first = seg_reduce(first, [](int a, int o) { return min(a, o); });
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (j * E + e == first) cur[e] = -1.0f;
    kth = m;
  }

  // candidates ranked in t order: an exclusive count over the segment
  bool cand[E];
  int mine = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    cand[e] = j * E + e < k && valid && w[e] >= kth && w[e] > p.w_eps;
    mine += cand[e] ? 1 : 0;
  }
  int incl = mine;
#pragma unroll
  for (int d = 1; d < kSeg; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d, kSeg);
    if (j >= d) incl += v;
  }
  const int n_cand = __shfl_sync(kFull, incl, kSeg - 1, kSeg);
  int run = incl - mine, rank[E];
  float skip[E], cs[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool keep = cand[e] && run < cap;
    rank[e] = keep ? run : -1;
    skip[e] = (keep || !valid) ? 0.0f : sdt[e];
    cs[e] = skip[e];
    run += cand[e] ? 1 : 0;
  }
  seg_scan<E>(cs, j);
  if (live) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (rank[e] >= 0) {
        o_t[rank[e]] = t[e];
        o_s[rank[e]] = cs[e] - skip[e];
        o_v[rank[e]] = 1;
      }
    }
    for (int c = min(n_cand, cap) + j; c < cap; c += kSeg) {
      o_t[c] = 0.0f;
      o_s[c] = 0.0f;
      o_v[c] = 0;
    }
  }
}

// ---- the kernel: one tile a block -------------------------------------

template <int KP, bool kTopK>
__global__ void __launch_bounds__(kThreads)
select_kernel(const __grid_constant__ Params p,
              const __grid_constant__ Quantiles q) {
  constexpr int E = KP / kSeg;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(p.k, p.cap, kTopK);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar0);
  unsigned char* out = smem + L.out0;
  const InStage st = in_stage<kTopK>(smem, L);
  const int tid = threadIdx.x;
  const int r = tid / kSeg, j = tid % kSeg;        // ray of the tile, slice
  const int row0 = blockIdx.x * kRays;
  const int rows = min(kRays, p.n - row0);

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) issue_tile<kTopK>(p, L, smem, bar, row0);
  mbar_wait(bar, 0);
  if (rows < kRays) load_tails<kTopK>(p, st, row0, rows, tid);
  __syncthreads();

  // every thread computes (shuffles span the warp); rays past the ragged
  // tile's end compute on zeros and write nothing
  const bool live = r < rows;
  const float tlo = live ? st.lo[r] : 0.0f;
  const float thi = live ? st.hi[r] : 0.0f;
  float* o0 = reinterpret_cast<float*>(out) + r * p.cap;
  float* o1 = reinterpret_cast<float*>(out + L.out_rows) + r * p.cap;
  uint8_t* ov = out + 2 * L.out_rows + r * p.cap;
  if constexpr (kTopK) {
    topk_ray<E>(p, st.ts + r * p.k, st.sig + r * p.k, tlo, thi, j, live,
                o0, o1, ov);
  } else {
    float* rcdf = reinterpret_cast<float*>(smem + L.scr0) + r * L.row;
    cdf_ray<E>(p, q, st.sig + r * p.k, tlo, thi, j, live, rcdf,
               rcdf + kRays * L.row, o0, o1, ov);
  }
  fence_proxy_async();
  __syncthreads();

  if (tid == 0) {
    store_tile(p, L, out, row0, rows);
    bulk_wait_read();
  }
  if (rows < kRays) store_tails(p, L, out, row0, rows, tid);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <int KP, bool kTopK>
void launch_kp(const Params& p, const Quantiles& q, uint32_t smem,
               cudaStream_t stream) {
  select_kernel<KP, kTopK><<<(p.n + kRays - 1) / kRays, kThreads, smem,
                             stream>>>(p, q);
}

template <bool kTopK>
int launch(const Params& p, const Quantiles& q, void* stream) {
  if (p.n <= 0) return 0;
  if (p.k < 1 || p.k > kMaxK || p.cap < 1 || p.cap > p.k)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kTopK && !aligned16(p.ts)) || !aligned16(p.sig) ||
      !aligned16(p.t_lo) || !aligned16(p.t_hi) || !aligned16(p.out0) ||
      !aligned16(p.out1) || !aligned16(p.valid2))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const uint32_t smem = make_layout(p.k, p.cap, kTopK).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((p.k + kSeg - 1) / kSeg) {
    case 1: launch_kp<8, kTopK>(p, q, smem, s); break;
    case 2: launch_kp<16, kTopK>(p, q, smem, s); break;
    case 3: launch_kp<24, kTopK>(p, q, smem, s); break;
    default: launch_kp<32, kTopK>(p, q, smem, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int proxy_select_launch(const void* ts, const void* sig,
                                   const void* t_lo, const void* t_hi,
                                   void* ts2, void* skip2, void* valid2,
                                   int n, int k, int cap, float w_eps,
                                   void* stream) {
  const Params p{static_cast<const float*>(ts),
                 static_cast<const float*>(sig),
                 static_cast<const float*>(t_lo),
                 static_cast<const float*>(t_hi),
                 static_cast<float*>(ts2), static_cast<float*>(skip2),
                 static_cast<uint8_t*>(valid2), n, k, cap, w_eps, 0.0f};
  return launch<true>(p, Quantiles{}, stream);
}

// quantiles: cap host floats, u[c] = float((c + 0.5) / cap)
extern "C" int proxy_select_cdf_launch(const void* sig, const void* t_lo,
                                       const void* t_hi, void* ts2,
                                       void* dt2, void* valid2,
                                       const float* quantiles, int n, int k,
                                       int cap, float w_eps, float dt_clamp,
                                       void* stream) {
  const Params p{nullptr, static_cast<const float*>(sig),
                 static_cast<const float*>(t_lo),
                 static_cast<const float*>(t_hi),
                 static_cast<float*>(ts2), static_cast<float*>(dt2),
                 static_cast<uint8_t*>(valid2), n, k, cap, w_eps, dt_clamp};
  if (cap < 1 || cap > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  Quantiles q{};
  for (int c = 0; c < cap; ++c) q.u[c] = quantiles[c];
  return launch<false>(p, q, stream);
}
