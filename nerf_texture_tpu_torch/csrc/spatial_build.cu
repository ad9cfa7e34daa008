// The grid-hash engine's tables on the card: the per-cell item lists of a
// uniform res^3 voxel grid over vertices or triangles, and each cell's
// fallback list (the k items nearest to the cell's centre).
//
// Replaces no TPU kernel.  It replaces host code of the JAX package:
// native/spatial_build.cpp (build_vertex_grid, build_triangle_grid, bound
// through nerf_texture_tpu/native.py) and the scipy.spatial.cKDTree query
// of nerf_texture_tpu/geometry/spatial.py::_build_fallback.  Every mesh
// projector the port builds (the curved template, the imports of
// train/field_io.py, the vertex encoder's feature mesh, the curved
// synthesis' plane) runs these.
//
// Binning, for both grids, in three kernels queued by two entry points:
//   bin_pass (count)  -- each item's cell range; one atomic count per cell
//   exclusive_scan    -- one block: the counts' exclusive prefix sums
//                        (the cells' segments) and a copy as cursors
//   bin_pass (fill)   -- each (cell, item) pair into its cell's segment at
//                        an atomic cursor (any order within the segment)
//   cell_lists        -- one warp a cell: the cell's M lowest item ids in
//                        ascending order, -1 padded
// A cell's list so holds its lowest ids first, as the C++ builder's loop
// over the items in id order fills it.  A cell is computed as the C++
// builder computes it, in float32: (int)((v - origin) / cell_size),
// truncated toward zero, clamped to [0, res - 1]; a triangle covers the
// cells of the AABB of its three float32 corners.  The library compiles
// with --fmad=false and IEEE division, so the subtraction and the
// division round as they do on the host, and the tables are the host
// builder's bit for bit.
//
// Fallback lists, one kernel:
//   kd_nearest        -- one thread a cell centre ((i + 0.5) * cell_size +
//                        origin in float64): scipy's cKDTree query
//                        (scipy/spatial/ckdtree/src/query.cxx,
//                        query_single_point, p = 2, eps = 0) over the
//                        tree scipy built on the host from the same items,
//                        step for step: the best-first walk with its node
//                        heap, the k-item heap, the same comparisons and
//                        the same float64 arithmetic (no fused
//                        multiply-add), and the heapsort of the result.
//                        Its lists are so cKDTree's bit for bit, ties and
//                        their order included: among items at equal
//                        distance cKDTree keeps those its walk meets
//                        first, and no other rule reproduces that.  The
//                        node heap lives in a scratch slice of global
//                        memory per thread (qmax entries); a row that
//                        outgrows it is flagged and run again with more.
//
// What bounds it on an H100: the binning moves a few MB (the items in,
// the [res^3, M] table out, the pair scratch twice), so it is bound by
// bytes and by its launches.  The fallback's work depends on the data:
// each (centre, item) distance the walk evaluates is 3 subtractions, 3
// multiplications and 3 additions in float64 (the kernel counts them);
// the heap and the walk's branches ride beside them, one thread a centre.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int K = 8;                  // the most items a fallback list holds
constexpr int KD_BLOCK = 128;

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
    return a < b ? a : b;
}

struct Grid {
    int res;
    float ox, oy, oz, cs;
};

__device__ __forceinline__ int cell_axis(float v, float o, float cs,
                                         int res) {
    int c = (int)((v - o) / cs);
    return min(max(c, 0), res - 1);
}

// The cell range [lo, hi] (per axis) of item i: a vertex's one cell, or
// the cells of a triangle's AABB when faces is not null.
__device__ __forceinline__ void item_range(const float* __restrict__ verts,
                                           const int32_t* __restrict__ faces,
                                           int64_t i, const Grid& g,
                                           int lo[3], int hi[3]) {
    const float o[3] = {g.ox, g.oy, g.oz};
    if (faces == nullptr) {
        for (int d = 0; d < 3; ++d) {
            lo[d] = hi[d] = cell_axis(verts[i * 3 + d], o[d], g.cs, g.res);
        }
        return;
    }
    const int64_t a = faces[i * 3 + 0], b = faces[i * 3 + 1],
                  c = faces[i * 3 + 2];
    for (int d = 0; d < 3; ++d) {
        const float va = verts[a * 3 + d], vb = verts[b * 3 + d],
                    vc = verts[c * 3 + d];
        lo[d] = cell_axis(fminf(va, fminf(vb, vc)), o[d], g.cs, g.res);
        hi[d] = cell_axis(fmaxf(va, fmaxf(vb, vc)), o[d], g.cs, g.res);
    }
}

// pairs == nullptr: count each item's cells into counts; else write each
// item into its cells' segments at cursor (the segments' running ends).
__global__ void bin_pass(const float* __restrict__ verts,
                         const int32_t* __restrict__ faces, int64_t n,
                         Grid g, int32_t* __restrict__ counts,
                         unsigned long long* __restrict__ cursor,
                         int32_t* __restrict__ pairs) {
    const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (i >= n) return;
    int lo[3], hi[3];
    item_range(verts, faces, i, g, lo, hi);
    for (int x = lo[0]; x <= hi[0]; ++x)
        for (int y = lo[1]; y <= hi[1]; ++y)
            for (int z = lo[2]; z <= hi[2]; ++z) {
                const int64_t cell = ((int64_t)x * g.res + y) * g.res + z;
                if (pairs == nullptr) {
                    atomicAdd(&counts[cell], 1);
                } else {
                    pairs[atomicAdd(&cursor[cell], 1ull)] = (int32_t)i;
                }
            }
}

// One block: offsets[c] = sum of counts[0..c), offsets[n] = the total;
// cursor = offsets[0..n).  Each thread sums a contiguous run of cells,
// the block scans the runs' sums, then each thread writes its run.
__global__ void exclusive_scan(const int32_t* __restrict__ counts,
                               int64_t n,
                               unsigned long long* __restrict__ offsets,
                               unsigned long long* __restrict__ cursor) {
    __shared__ unsigned long long part[SCAN_THREADS];
    const int t = threadIdx.x;
    const int64_t run = (n + SCAN_THREADS - 1) / SCAN_THREADS;
    const int64_t beg = imin(n, t * run), end = imin(n, beg + run);
    unsigned long long s = 0;
    for (int64_t c = beg; c < end; ++c) s += (unsigned)counts[c];
    part[t] = s;
    __syncthreads();
    for (int step = 1; step < SCAN_THREADS; step <<= 1) {
        const unsigned long long add = t >= step ? part[t - step] : 0ull;
        __syncthreads();
        part[t] += add;
        __syncthreads();
    }
    unsigned long long acc = part[t] - s;       // exclusive
    for (int64_t c = beg; c < end; ++c) {
        offsets[c] = acc;
        cursor[c] = acc;
        acc += (unsigned)counts[c];
    }
    if (t == SCAN_THREADS - 1) offsets[n] = part[t];
}

// One warp a cell: its segment's M lowest ids, ascending, -1 padded.  The
// ids of a segment are distinct (an item lands in a cell once), so the
// j-th is the least id above the (j-1)-th.
__global__ void cell_lists(const int32_t* __restrict__ pairs,
                           const unsigned long long* __restrict__ offsets,
                           int64_t n_cells, int M,
                           int32_t* __restrict__ cell_items) {
    const int lane = threadIdx.x & 31;
    const int64_t cell = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x)
                         >> 5;
    if (cell >= n_cells) return;
    const int64_t beg = (int64_t)offsets[cell];
    const int64_t cnt = (int64_t)offsets[cell + 1] - beg;
    int32_t* row = cell_items + cell * M;
    int last = -1;
    const int m = (int)imin(cnt, M);
    for (int j = 0; j < m; ++j) {
        int best = 0x7fffffff;
        for (int64_t p = lane; p < cnt; p += 32) {
            const int id = pairs[beg + p];
            if (id > last && id < best) best = id;
        }
        best = __reduce_min_sync(0xffffffffu, best);
        if (lane == 0) row[j] = best;
        last = best;
    }
    for (int j = m + lane; j < M; j += 32) row[j] = -1;
}

// The walk's node heap and item heap: scipy's ckdtree heap, a
// binary min-heap on the priority; an item moves up only while strictly
// below its parent, and down only while strictly above a child.
template <typename T>
__device__ __forceinline__ void heap_push(double* pr, T* val, int& n,
                                          double p, T v) {
    int i = n++;
    pr[i] = p;
    val[i] = v;
    while (i > 0 && pr[i] < pr[(i - 1) / 2]) {
        const int up = (i - 1) / 2;
        const double tp = pr[up];
        const T tv = val[up];
        pr[up] = pr[i];
        val[up] = val[i];
        pr[i] = tp;
        val[i] = tv;
        i = up;
    }
}

template <typename T>
__device__ __forceinline__ void heap_remove(double* pr, T* val, int& n) {
    pr[0] = pr[n - 1];
    val[0] = val[n - 1];
    --n;
    int i = 0, j = 1, k = 2;
    while ((j < n && pr[i] > pr[j]) || (k < n && pr[i] > pr[k])) {
        const int l = (k < n && pr[j] > pr[k]) ? k : j;
        const double tp = pr[l];
        const T tv = val[l];
        pr[l] = pr[i];
        val[l] = val[i];
        pr[i] = tp;
        val[i] = tv;
        i = l;
        j = 2 * i + 1;
        k = 2 * i + 2;
    }
}

// scipy's side distance of x to [lo, hi] on one axis, squared.
__device__ __forceinline__ double side2(double x, double lo, double hi) {
    double s = 0.0;
    double t = x - hi;
    if (t > s) {
        s = t;
    } else {
        t = lo - x;
        if (t > s) s = t;
    }
    return s * s;
}

// One thread a cell centre (cells row0 + t, or rows[t]): cKDTree's k
// nearest of the items.  pts [n, 3] float64 and ids [n] are in the
// tree's leaf order; nodes [n_nodes] hold (split_dim or -1 for a leaf,
// lesser or the leaf's first point, greater or its end); rects [n_nodes,
// 6] each node's box (lo xyz, hi xyz) as the walk's splits cut it from
// the data's bounds, from which a popped node's side distances come
// again bit for bit.  qpr / qnode: qmax heap entries a thread.  A row
// whose node heap would outgrow qmax sets overflow[t] and writes nothing.
__global__ void kd_nearest(const double* __restrict__ pts,
                           const int32_t* __restrict__ ids,
                           const int4* __restrict__ nodes,
                           const double* __restrict__ splits,
                           const double* __restrict__ rects,
                           const int64_t* __restrict__ rows, int64_t row0,
                           int64_t n_rows, int res, double ox, double oy,
                           double oz, double cs, int k, int F, int qmax,
                           double* __restrict__ qpr,
                           int* __restrict__ qnode,
                           int32_t* __restrict__ out,
                           int32_t* __restrict__ overflow,
                           unsigned long long* __restrict__ evals) {
    const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (t >= n_rows) return;
    const int64_t cell = rows != nullptr ? rows[t] : row0 + t;
    const int64_t ix = cell / ((int64_t)res * res), iy = (cell / res) % res,
                  iz = cell % res;
    const double x[3] = {((double)ix + 0.5) * cs + ox,
                         ((double)iy + 0.5) * cs + oy,
                         ((double)iz + 0.5) * cs + oz};
    double* hp = qpr + t * (int64_t)qmax;
    int* hn = qnode + t * (int64_t)qmax;
    int nq = 0;
    double npr[K];                      // the item heap: -distance, id
    int nid[K];
    int nn = 0;
    unsigned long long n_eval = 0;

    // the root: side distances to the data's bounds
    double side[3];
    double mind = 0.0;
    for (int d = 0; d < 3; ++d) {
        side[d] = side2(x[d], rects[d], rects[3 + d]);
        mind += side[d] - 0.0;
    }
    int node = 0;
    double dub = __longlong_as_double(0x7ff0000000000000ll);   // +inf
    for (;;) {
        const int4 nd = nodes[node];
        if (nd.x == -1) {               // a leaf: every point in order
            for (int i = nd.y; i < nd.z; ++i) {
                const double* p = pts + (int64_t)i * 3;
                double s = 0.0;
                for (int d = 0; d < 3; ++d) {
                    const double dd = p[d] - x[d];
                    s += dd * dd;
                }
                ++n_eval;
                if (s < dub) {
                    if (nn == k) heap_remove(npr, nid, nn);
                    heap_push(npr, nid, nn, -s, (int)ids[i]);
                    if (nn == k) dub = -npr[0];
                }
            }
            if (nq == 0) break;
            node = hn[0];
            mind = hp[0];
            heap_remove(hp, hn, nq);
            const double* r = rects + (int64_t)node * 6;
            for (int d = 0; d < 3; ++d) side[d] = side2(x[d], r[d], r[3 + d]);
        } else {
            if (mind > dub) break;
            const int dim = nd.x;
            const double split = splits[node];
            double sd;
            int far;
            if (x[dim] < split) {
                node = nd.y;
                far = nd.z;
                sd = split - x[dim];
            } else {
                node = nd.z;
                far = nd.y;
                sd = x[dim] - split;
            }
            sd = sd * sd;
            const double far_mind = mind + (sd - side[dim]);
            if (far_mind <= dub) {
                if (nq == qmax) {
                    overflow[t] = 1;
                    atomicAdd(evals, n_eval);
                    return;
                }
                heap_push(hp, hn, nq, far_mind, far);
            }
        }
    }
    atomicAdd(evals, n_eval);
    // the heapsort: the farthest popped first, to the last slot
    int res_id[K];
    const int got = nn;
    for (int i = got - 1; i >= 0; --i) {
        res_id[i] = nid[0];
        heap_remove(npr, nid, nn);
    }
    int32_t* row = out + cell * F;
    for (int j = 0; j < F; ++j) row[j] = res_id[j < got ? j : got - 1];
}

}  // namespace

extern "C" {

// Count pass and scan: counts [res^3] int32 (zeroed here), offsets
// [res^3 + 1] and cursor [res^3] uint64.  faces is null for the vertex
// grid (n vertices) and [n, 3] int32 for the triangle grid (n faces).
// Returns 0 or the CUDA error.
int spatial_bin_count(const float* verts, const int32_t* faces, int64_t n,
                      int res, float ox, float oy, float oz, float cs,
                      int32_t* counts, unsigned long long* offsets,
                      unsigned long long* cursor, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t n_cells = (int64_t)res * res * res;
    const Grid g{res, ox, oy, oz, cs};
    cudaError_t e = cudaMemsetAsync(counts, 0, n_cells * sizeof(int32_t),
                                    s);
    if (e != cudaSuccess) return (int)e;
    if (n > 0) {
        bin_pass<<<(unsigned)((n + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(
            verts, faces, n, g, counts, nullptr, nullptr);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    exclusive_scan<<<1, SCAN_THREADS, 0, s>>>(counts, n_cells, offsets,
                                              cursor);
    return (int)cudaGetLastError();
}

// Fill pass and the cells' lists: pairs [offsets[res^3]] int32 scratch,
// cell_items [res^3, M] int32.  Returns 0 or the CUDA error.
int spatial_bin_fill(const float* verts, const int32_t* faces, int64_t n,
                     int res, float ox, float oy, float oz, float cs,
                     const unsigned long long* offsets,
                     unsigned long long* cursor, int32_t* pairs, int M,
                     int32_t* cell_items, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t n_cells = (int64_t)res * res * res;
    const Grid g{res, ox, oy, oz, cs};
    cudaError_t e;
    if (n > 0) {
        bin_pass<<<(unsigned)((n + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(
            verts, faces, n, g, nullptr, cursor, pairs);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    const int64_t warps_per_block = BLOCK / 32;
    cell_lists<<<(unsigned)((n_cells + warps_per_block - 1)
                            / warps_per_block), BLOCK, 0, s>>>(
        pairs, offsets, n_cells, M, cell_items);
    return (int)cudaGetLastError();
}

// The fallback lists: out [res^3, F] int32, cKDTree's k nearest (1 <=
// k <= 8, k <= F) of each cell centre, the k-th repeated past k.  One
// launch over rows (n_rows cells from rows, or from row0 on when rows is
// null); qpr / qnode scratch of n_rows x qmax entries; overflow [n_rows]
// int32 (zeroed here); evals one uint64 that each row adds its
// distance evaluations to.  Returns 0, -1 for arguments out of range, or
// the CUDA error.
int spatial_kd_nearest(const double* pts, const int32_t* ids,
                       const int32_t* nodes, const double* splits,
                       const double* rects, const int64_t* rows,
                       int64_t row0, int64_t n_rows, int res, double ox,
                       double oy, double oz, double cs, int k, int F,
                       int qmax, double* qpr, int* qnode, int32_t* out,
                       int32_t* overflow, unsigned long long* evals,
                       void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (k < 1 || k > K || k > F || qmax < 1 || n_rows < 1) return -1;
    cudaError_t e = cudaMemsetAsync(overflow, 0, n_rows * sizeof(int32_t),
                                    s);
    if (e != cudaSuccess) return (int)e;
    const int64_t blocks = (n_rows + KD_BLOCK - 1) / KD_BLOCK;
    kd_nearest<<<(unsigned)blocks, KD_BLOCK, 0, s>>>(
        pts, ids, (const int4*)nodes, splits, rects, rows, row0, n_rows, res,
        ox, oy, oz, cs, k, F, qmax, qpr, qnode, out, overflow, evals);
    return (int)cudaGetLastError();
}

}  // extern "C"
