// K2 -- splat-tile pair expansion (CUDA's duplicateWithKeys).
//
// Replaces: gs2pc/ops/rasterize.py::_build_pairs (:250-510), the JAX
// package's static-budget expansion (waterfilled windows, a scatter +
// cummax inverse of the prefix sum, packed sort keys).  On the GPU the
// pair count is known exactly from a prefix sum of the per-Gaussian
// counts, so there is no budget, no waterfill and no window.
//
// Two launches per camera, after the depth sort (csrc/sort.cu) has put the
// Gaussians in rank order (order[r] is the gid of rank r):
//   count_pairs  one thread per Gaussian: the number of rect tiles it
//                emits (the full rect, or in non-surface mode the tiles
//                that pass the AdR circle-vs-tile cull), by gid;
//   write_pairs  at O(r) (the exclusive prefix sum of the counts taken in
//                rank order, read from the inclusive one, ends) one int32
//                tile id ty * grid_w + tx and one int32 gid per tile that
//                Gaussian order[r] emits, rect row-major.
// Either way every pair lands at the same index: rank-major, rect
// row-major within a Gaussian, which the PyTorch twin's order moved to rank
// order (rasterize.duplicate_with_keys on CPU tensors) is too.  The tile
// sort after it then needs the tile id alone as its key.
//
// What bounds write_pairs: device-memory writes of 8 bytes per pair (the
// reads are ~33 bytes per Gaussian, each rank's inputs gathered through
// order).  In full-rect mode (the main path's surface mode) it is
// pair-parallel, so a screen-sized splat no longer serialises its
// thousands of writes in one thread and every write is coalesced: each
// block takes a span of K2_ITEMS items of the merge of the ranks' start
// offsets with the pair indices (merge path, as a load-balanced search), so
// it holds at most K2_ITEMS pairs and Gaussians together however the pairs
// are spread.  Two warps find the span's ends with a 32-way search over
// ends; the block stages its ranks' offsets, rects and gids in shared
// memory; each thread maps its pairs to (rank, k) by a binary search there
// and to (tx, ty) = rect_min + (k mod w, k div w).  In circle-cull mode a
// thread walks one rank's rect: both passes call the same tile_hit() test,
// with the float operations pinned to round-to-nearest (no FMA
// contraction), so they agree and the output equals the twin bit for bit.
#include "common.cuh"

// Measured at the main path's shape: 128 threads beat 256 and 512, 1,024
// items beat 512 (PERF.md).
#define K2_THREADS 128
#define K2_ITEMS 1024  // Gaussians + pairs merged per block
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ bool tile_hit(float px, float py, float r2, int tx, int ty) {
    const float fx = (float)(tx * TILE_EDGE);
    const float fy = (float)(ty * TILE_EDGE);
    const float cx = fminf(fmaxf(px, fx), __fadd_rn(fx, (float)(TILE_EDGE - 1)));
    const float cy = fminf(fmaxf(py, fy), __fadd_rn(fy, (float)(TILE_EDGE - 1)));
    const float ddx = __fsub_rn(cx, px);
    const float ddy = __fsub_rn(cy, py);
    return __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)) <= r2;
}

// Exclusive prefix sum of the counts at rank r, from the inclusive one.
__device__ __forceinline__ int64_t start_of(const int64_t* __restrict__ ends, int r) {
    return r > 0 ? ends[r - 1] : 0;
}

__global__ void count_pairs_kernel(const float* __restrict__ xy,
                                   const float* __restrict__ r_alpha_sq,
                                   const int* __restrict__ rect_min,
                                   const int* __restrict__ rect_max,
                                   const uint8_t* __restrict__ valid, int P,
                                   int circle_cull, int* __restrict__ counts) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= P) return;
    if (!valid[g]) {
        counts[g] = 0;
        return;
    }
    const int x0 = rect_min[2 * g], y0 = rect_min[2 * g + 1];
    const int x1 = rect_max[2 * g], y1 = rect_max[2 * g + 1];
    if (!circle_cull) {
        counts[g] = (x1 - x0) * (y1 - y0);
        return;
    }
    const float px = xy[2 * g], py = xy[2 * g + 1], r2 = r_alpha_sq[g];
    int c = 0;
    for (int ty = y0; ty < y1; ++ty)
        for (int tx = x0; tx < x1; ++tx) c += tile_hit(px, py, r2, tx, ty) ? 1 : 0;
    counts[g] = c;
}

// Circle-cull mode: one thread per rank walks its Gaussian's rect.  A rank
// whose count is 0 (every invalid Gaussian among them) stops before it
// gathers anything through order.
__global__ void write_pairs_cull_kernel(const float* __restrict__ xy,
                                        const float* __restrict__ r_alpha_sq,
                                        const int* __restrict__ rect_min,
                                        const int* __restrict__ rect_max,
                                        const int* __restrict__ order,
                                        const int64_t* __restrict__ ends, int P, int grid_w,
                                        int* __restrict__ tiles, int* __restrict__ gids) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= P) return;
    int64_t o = start_of(ends, r);
    if (ends[r] == o) return;
    const int g = order[r];
    const int x0 = rect_min[2 * g], y0 = rect_min[2 * g + 1];
    const int x1 = rect_max[2 * g], y1 = rect_max[2 * g + 1];
    const float px = xy[2 * g], py = xy[2 * g + 1], r2 = r_alpha_sq[g];
    for (int ty = y0; ty < y1; ++ty) {
        for (int tx = x0; tx < x1; ++tx) {
            if (!tile_hit(px, py, r2, tx, ty)) continue;
            tiles[o] = ty * grid_w + tx;
            gids[o] = g;
            ++o;
        }
    }
}

// Merge path: rank r stands at r + O(r) in the merge of the start offsets
// with the pair indices (a start before the pair at its own index).
// Returns the number of ranks before merged position d, the least a in
// [0, P] with a == P or a + O(a) >= d; every lane of the calling warp takes
// part and gets it.  Each round probes 32 points and keeps the gap between
// the last probe below d and the first at or above it.
__device__ int merge_split(const int64_t* __restrict__ ends, int P, int64_t d) {
    const int lane = threadIdx.x & 31;
    int lo = 0, hi = P;
    while (lo < hi) {
        const int step = (hi - lo + 31) / 32;
        const int64_t idx = lo + (int64_t)lane * step;
        const bool at_or_above = idx >= hi || idx + start_of(ends, (int)idx) >= d;
        const unsigned ballot = __ballot_sync(FULL_MASK, at_or_above);
        if (ballot == 0u) {
            lo += 31 * step + 1;
        } else {
            const int f = __ffs(ballot) - 1;
            if (f == 0) {
                hi = lo;
            } else {
                hi = min(hi, lo + f * step);
                lo += (f - 1) * step + 1;
            }
        }
    }
    return lo;
}

// Full-rect mode: pair-parallel over merge-path spans.
__global__ void __launch_bounds__(K2_THREADS) write_pairs_rect_kernel(
    const int* __restrict__ rect_min, const int* __restrict__ rect_max,
    const int* __restrict__ order, const int64_t* __restrict__ ends, int P, int64_t total,
    int grid_w, int* __restrict__ tiles, int* __restrict__ gids) {
    __shared__ int64_t s_start[K2_ITEMS + 1];
    __shared__ int s_x0[K2_ITEMS + 1], s_y0[K2_ITEMS + 1], s_w[K2_ITEMS + 1];
    __shared__ int s_gid[K2_ITEMS + 1];
    __shared__ int s_split[2];
    const int64_t d0 = (int64_t)blockIdx.x * K2_ITEMS;
    const int64_t d1 = min(d0 + K2_ITEMS, (int64_t)P + total);
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
        const int a = merge_split(ends, P, warp == 0 ? d0 : d1);
        if ((threadIdx.x & 31) == 0) s_split[warp] = a;
    }
    __syncthreads();
    const int a0 = s_split[0], a1 = s_split[1];
    // The span's pairs belong to ranks a0 - 1 .. a1 - 1 (a0 - 1 may have
    // started in an earlier span).
    const int r_lo = max(a0 - 1, 0);
    const int n_r = a1 - r_lo;
    for (int i = threadIdx.x; i < n_r; i += K2_THREADS) {
        const int r = r_lo + i;
        s_start[i] = start_of(ends, r);
        // A rank with no pair is never the last to start at or before a
        // pair of the span (the next rank starts there too), so its
        // Gaussian is not gathered.
        if (ends[r] == s_start[i]) continue;
        const int g = order[r];
        const int x0 = rect_min[2 * g];
        s_x0[i] = x0;
        s_y0[i] = rect_min[2 * g + 1];
        s_w[i] = rect_max[2 * g] - x0;
        s_gid[i] = g;
    }
    __syncthreads();
    const int64_t b1 = d1 - a1;
    for (int64_t b = d0 - a0 + threadIdx.x; b < b1; b += K2_THREADS) {
        // The last staged rank starting at or before b: the one holding it
        // (ranks with no pair share the next one's start).
        int lo = 0, hi = n_r - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (s_start[mid] <= b) lo = mid;
            else hi = mid - 1;
        }
        const int k = (int)(b - s_start[lo]);
        const int w = s_w[lo];
        const int tx = s_x0[lo] + k % w, ty = s_y0[lo] + k / w;
        tiles[b] = ty * grid_w + tx;
        gids[b] = s_gid[lo];
    }
}

GS2PC_API int gs2pc_count_pairs(const void* xy, const void* r_alpha_sq, const void* rect_min,
                                const void* rect_max, const void* valid, int P,
                                int circle_cull, void* counts, void* stream) {
    if (P > 0) {
        const int threads = 256;
        count_pairs_kernel<<<(P + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
            (const float*)xy, (const float*)r_alpha_sq, (const int*)rect_min,
            (const int*)rect_max, (const uint8_t*)valid, P, circle_cull, (int*)counts);
    }
    return (int)cudaGetLastError();
}

GS2PC_API int gs2pc_write_pairs(const void* xy, const void* r_alpha_sq, const void* rect_min,
                                const void* rect_max, const void* order,
                                const void* ends, int P, long long total, int circle_cull,
                                int grid_w, void* tiles, void* gids, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (P > 0 && total > 0) {
        if (circle_cull) {
            write_pairs_cull_kernel<<<(P + 255) / 256, 256, 0, st>>>(
                (const float*)xy, (const float*)r_alpha_sq, (const int*)rect_min,
                (const int*)rect_max, (const int*)order,
                (const int64_t*)ends, P, grid_w, (int*)tiles, (int*)gids);
        } else {
            const long long blocks = ((long long)P + total + K2_ITEMS - 1) / K2_ITEMS;
            write_pairs_rect_kernel<<<(unsigned)blocks, K2_THREADS, 0, st>>>(
                (const int*)rect_min, (const int*)rect_max, (const int*)order,
                (const int64_t*)ends, P, (int64_t)total, grid_w, (int*)tiles, (int*)gids);
        }
    }
    return (int)cudaGetLastError();
}
