// The minimum s-t cut of GrabCut's 8-connected grid graph, for Hopper
// (sm_90a), in float64.
//
// Replaces no TPU kernel: it replaces GCGraph::maxFlow (OpenCV's
// Boykov-Kolmogorov max-flow), which cv2.grabCut runs on the host for
// nerf_texture_tpu/data/segmenter.py:103 and data/prepare.py:76.  The
// plain PyTorch version of the same phases is min_cut_reference in
// ops/maxflow.py (the CPU path and this kernel's oracle).
//
// Layout: cap / c / out are [8][H][W] (direction-major, so a warp reads
// 32 neighbouring nodes of one direction at once), e / rs / h [H][W].
// Direction k steps (kDY[k], kDX[k]); its opposite is (k + 4) & 7.
//
// A residual at or below kTol (1e-12) counts as saturated: partial pushes
// leave a few ulps on an edge that Boykov-Kolmogorov would zero exactly.
//
// Algorithm: push-relabel.  A global relabel sets h to each node's
// distance to the sink in the residual graph (n = H * W if it cannot reach
// it); when no node with excess has h < n the flow is a maximum preflow
// and the source side of the cut is {h == n}.  Else up to relabel_every
// sweeps follow, each of three launches:
//   push:    every active node (e > 0, h < n) sends min(e, rs) to the sink
//            when h == 1, then down each admissible edge (c > 0, neighbour
//            height h - 1) in direction order, writing out[k][v];
//   apply:   every node gathers out[(k + 4) & 7] of its neighbours in
//            direction order (no float atomics: two runs give the same
//            flow) and updates its residuals;
//   relabel: an active node without an admissible edge takes one more
//            than its lowest residual neighbour (1 if it reaches the sink),
//            into the second height buffer, and the nodes still active
//            are counted.
// A sweep that starts with that count at 0 does nothing (its launches
// return at once; relabel copies the heights): the host queues a whole
// batch without reading the count, and the device skips what is left of
// it once the preflow is maximal.  Only the sweeps that ran are counted.
// The global relabel relaxes heights tile by tile (32 x 32 nodes a block,
// the tile and its halo in shared memory, up to 128 rounds inside the
// block) until a launch changes nothing: the BFS distances are the unique
// fixed point, so the result does not depend on the order blocks run in.
//
// Bound: each sweep reads c and writes out (8 doubles a node each way),
// reads them again in apply and relabel, plus e, rs and the heights of 9
// nodes: memory-bound, ~40 doubles a node a sweep at 3.35 TB/s.  Nothing
// here is tuned: the host queues every launch and reads one flag per
// relabel round.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__constant__ int kDY[8] = {0, -1, -1, -1, 0, 1, 1, 1};
__constant__ int kDX[8] = {-1, -1, 0, 1, 1, 1, 0, -1};

// a residual at or below kTol counts as saturated (TOL in ops/maxflow.py)
constexpr double kTol = 1e-12;
constexpr int kTile = 32;
constexpr int kThreads = 256;

__global__ void init_kernel(const double* __restrict__ cap,
                            const double* __restrict__ weight,
                            double* __restrict__ c, double* __restrict__ e,
                            double* __restrict__ rs, int hw) {
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < hw;
       v += gridDim.x * blockDim.x) {
    const double w = weight[v];
    e[v] = w > 0.0 ? w : 0.0;
    rs[v] = w < 0.0 ? -w : 0.0;
    for (int k = 0; k < 8; ++k) {
      c[(size_t)k * hw + v] = cap[(size_t)k * hw + v];
    }
  }
}

__global__ void fill_kernel(int* __restrict__ h, int value, int hw) {
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < hw;
       v += gridDim.x * blockDim.x) {
    h[v] = value;
  }
}

// One round of the global relabel: h(v) = min(h(v), 1 if v reaches the
// sink, h(u) + 1 over residual edges v -> u), iterated inside the tile.
__global__ void __launch_bounds__(kTile * kTile)
relax_tile(const double* __restrict__ c, const double* __restrict__ rs,
           int* h, int H, int W, int n, int* changed) {
  __shared__ int sh[kTile + 2][kTile + 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int x = x0 + tx, y = y0 + ty;
  const int hw = H * W;
  const bool inside = x < W && y < H;
  const int tid = ty * kTile + tx;
  for (int i = tid; i < (kTile + 2) * (kTile + 2); i += kTile * kTile) {
    const int hy = i / (kTile + 2), hx = i % (kTile + 2);
    const int gy = y0 + hy - 1, gx = x0 + hx - 1;
    sh[hy][hx] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? h[gy * W + gx]
                                                          : n;
  }
  unsigned mask = 0u;
  bool sink = false;
  const int v = y * W + x;
  if (inside) {
    for (int k = 0; k < 8; ++k) {
      if (c[(size_t)k * hw + v] > kTol) mask |= 1u << k;
    }
    sink = rs[v] > kTol;
  }
  __syncthreads();
  int cur = inside ? sh[ty + 1][tx + 1] : n;
  bool moved = false;
  for (int round = 0; round < 4 * kTile; ++round) {
    int best = cur;
    if (inside) {
      if (sink) best = 1;
      for (int k = 0; k < 8; ++k) {
        if (mask & (1u << k)) {
          const int hn = sh[ty + 1 + kDY[k]][tx + 1 + kDX[k]];
          if (hn + 1 < best) best = hn + 1;
        }
      }
    }
    __syncthreads();
    const bool step = best < cur;
    if (step) {
      cur = best;
      sh[ty + 1][tx + 1] = best;
      moved = true;
    }
    if (!__syncthreads_or(step)) break;
  }
  if (moved) {
    h[v] = cur;
    atomicOr(changed, 1);
  }
}

__global__ void count_active(const double* __restrict__ e,
                             const int* __restrict__ h, int n, int hw,
                             int* __restrict__ count) {
  int local = 0;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < hw;
       v += gridDim.x * blockDim.x) {
    if (e[v] > 0.0 && h[v] < n) ++local;
  }
  for (int off = 16; off > 0; off >>= 1) {
    local += __shfl_down_sync(0xffffffffu, local, off);
  }
  if ((threadIdx.x & 31) == 0 && local > 0) atomicAdd(count, local);
}

// live_in: the nodes active at the start of this sweep (0: the sweep does
// nothing); live_out is zeroed for relabel to count into; ran counts the
// sweeps that did work.
__global__ void push_kernel(const double* __restrict__ c,
                            double* __restrict__ e, double* __restrict__ rs,
                            const int* __restrict__ h,
                            double* __restrict__ out, int H, int W, int n,
                            const int* live_in, int* live_out, int* ran) {
  const bool idle = *live_in == 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *live_out = 0;
    if (!idle) ++*ran;
  }
  if (idle) return;
  const int hw = H * W;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < hw;
       v += gridDim.x * blockDim.x) {
    const int y = v / W, x = v - y * W;
    const double ev = e[v];
    const int hv = h[v];
    const bool act = ev > 0.0 && hv < n;
    double rem = ev;
    if (act && hv == 1) {
      const double r = rs[v];
      if (r > kTol) {
        const double d = fmin(rem, r);
        rs[v] = r - d;
        rem = rem - d;
      }
    }
    for (int k = 0; k < 8; ++k) {
      double o = 0.0;
      if (act && rem > 0.0) {
        const double ck = c[(size_t)k * hw + v];
        const int ny = y + kDY[k], nx = x + kDX[k];
        if (ck > kTol && ny >= 0 && ny < H && nx >= 0 && nx < W &&
            h[ny * W + nx] == hv - 1) {
          o = fmin(rem, ck);
          rem = rem - o;
        }
      }
      out[(size_t)k * hw + v] = o;
    }
    e[v] = rem;
  }
}

__global__ void apply_kernel(double* __restrict__ c, double* __restrict__ e,
                             const double* __restrict__ out, int H, int W,
                             const int* live_in) {
  if (*live_in == 0) return;
  const int hw = H * W;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < hw;
       v += gridDim.x * blockDim.x) {
    const int y = v / W, x = v - y * W;
    double ev = e[v];
    for (int k = 0; k < 8; ++k) {
      const int ny = y + kDY[k], nx = x + kDX[k];
      double in = 0.0;
      if (ny >= 0 && ny < H && nx >= 0 && nx < W) {
        in = out[(size_t)((k + 4) & 7) * hw + ny * W + nx];
      }
      ev = ev + in;
      const size_t i = (size_t)k * hw + v;
      c[i] = (c[i] - out[i]) + in;
    }
    e[v] = ev;
  }
}

__global__ void relabel_kernel(const double* __restrict__ c,
                               const double* __restrict__ e,
                               const double* __restrict__ rs,
                               const int* __restrict__ h,
                               int* __restrict__ h2, int H, int W, int n,
                               const int* live_in, int* live_out) {
  const int hw = H * W;
  if (*live_in == 0) {
    for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < hw;
         v += gridDim.x * blockDim.x) {
      h2[v] = h[v];
    }
    return;
  }
  int live = 0;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < hw;
       v += gridDim.x * blockDim.x) {
    const int hv = h[v];
    int hnew = hv;
    const bool act = e[v] > 0.0 && hv < n;
    if (act) {
      const int y = v / W, x = v - y * W;
      const bool sink = rs[v] > kTol;
      bool adm = hv == 1 && sink;
      int low = sink ? 0 : n;
      for (int k = 0; k < 8; ++k) {
        const int ny = y + kDY[k], nx = x + kDX[k];
        if (c[(size_t)k * hw + v] > kTol && ny >= 0 && ny < H && nx >= 0 &&
            nx < W) {
          const int hn = h[ny * W + nx];
          if (hn == hv - 1) adm = true;
          if (hn < low) low = hn;
        }
      }
      if (!adm) hnew = low + 1 < n ? low + 1 : n;
    }
    h2[v] = hnew;
    if (act && hnew < n) ++live;
  }
  for (int off = 16; off > 0; off >>= 1) {
    live += __shfl_down_sync(0xffffffffu, live, off);
  }
  if ((threadIdx.x & 31) == 0 && live > 0) atomicAdd(live_out, live);
}

__global__ void source_kernel(const int* __restrict__ h,
                              unsigned char* __restrict__ source, int n,
                              int hw) {
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < hw;
       v += gridDim.x * blockDim.x) {
    source[v] = h[v] >= n ? 1 : 0;
  }
}

// Reads the int at dev into *host after everything queued on stream.
int read_flag(const int* dev, int* host, cudaStream_t stream) {
  cudaError_t err = cudaMemcpyAsync(host, dev, sizeof(int),
                                    cudaMemcpyDeviceToHost, stream);
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // namespace

// The whole cut: returns 0, -1 when no end came within max_sweeps sweeps,
// or a CUDA error code.  stats[0] = sweeps that ran, stats[1] = global
// relabels, stats[2] = kernel launches.  flags needs 4 ints of device
// memory (the relax flag, two active counts, the sweeps that ran); c,
// out: 8 H W doubles; e, rs: H W doubles; h0, h1: H W ints; source: H W
// bytes.
extern "C" int maxflow_grid(const double* cap, const double* weight,
                            double* c, double* out, double* e, double* rs,
                            int* h0, int* h1, int* flags,
                            unsigned char* source, int H, int W,
                            int relabel_every, int max_sweeps, int* stats,
                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int hw = H * W;
  const int n = hw;
  int blocks = (hw + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  const dim3 tile_block(kTile, kTile);
  const dim3 tile_grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  int* live = flags + 1;  // live[0], live[1]: the active counts, in turn
  int* ran = flags + 3;
  int* h = h0;
  int* h2 = h1;
  int flag = 0, err = 0;
  int queued = 0, relabels = 0, launches = 0, result = 0;
  cudaMemsetAsync(flags, 0, 4 * sizeof(int), stream);
  init_kernel<<<blocks, kThreads, 0, stream>>>(cap, weight, c, e, rs, hw);
  ++launches;
  while (true) {
    fill_kernel<<<blocks, kThreads, 0, stream>>>(h, n, hw);
    ++launches;
    do {
      cudaMemsetAsync(flags, 0, sizeof(int), stream);
      relax_tile<<<tile_grid, tile_block, 0, stream>>>(c, rs, h, H, W, n,
                                                       flags);
      ++launches;
      if ((err = read_flag(flags, &flag, stream)) != 0) return err;
    } while (flag != 0);
    ++relabels;
    cudaMemsetAsync(live, 0, sizeof(int), stream);
    count_active<<<blocks, kThreads, 0, stream>>>(e, h, n, hw, live);
    ++launches;
    if ((err = read_flag(live, &flag, stream)) != 0) return err;
    if (flag == 0) break;
    if (queued >= max_sweeps) {
      result = -1;
      break;
    }
    for (int s = 0; s < relabel_every; ++s) {
      const int* in = live + (s & 1);
      int* next = live + ((s + 1) & 1);
      push_kernel<<<blocks, kThreads, 0, stream>>>(c, e, rs, h, out, H, W,
                                                   n, in, next, ran);
      apply_kernel<<<blocks, kThreads, 0, stream>>>(c, e, out, H, W, in);
      relabel_kernel<<<blocks, kThreads, 0, stream>>>(c, e, rs, h, h2, H, W,
                                                      n, in, next);
      launches += 3;
      int* t = h;
      h = h2;
      h2 = t;
    }
    queued += relabel_every;
  }
  if (result == 0) {
    source_kernel<<<blocks, kThreads, 0, stream>>>(h, source, n, hw);
    ++launches;
  }
  int sweeps = 0;
  if ((err = read_flag(ran, &sweeps, stream)) != 0) return err;
  stats[0] = sweeps;
  stats[1] = relabels;
  stats[2] = launches;
  if (result != 0) return result;
  return (int)cudaGetLastError();
}
