// K2 -- splat-tile pair expansion (CUDA's duplicateWithKeys).
//
// Replaces: gs2pc/ops/rasterize.py::_build_pairs (:250-510), the JAX
// package's static-budget expansion (waterfilled windows, a scatter +
// cummax inverse of the prefix sum, packed sort keys).  On the GPU the
// pair count is known exactly from an exclusive prefix sum of the
// per-Gaussian counts, so there is no budget, no waterfill and no window.
//
// Two launches per camera:
//   count_pairs  one thread per Gaussian: the number of rect tiles it
//                emits (the full rect, or in non-surface mode the tiles
//                that pass the AdR circle-vs-tile cull);
//   write_pairs  one thread per Gaussian: at offsets[g] (the exclusive
//                cumsum of the counts) one int64 key
//                (tile_id << 32) | float_bits(depth) and one int32 gid per
//                emitted tile, rect row-major.
// Both passes call the same tile_hit() test, with the float operations
// pinned to round-to-nearest (no FMA contraction), so the two passes agree
// and the output equals the PyTorch twin bit for bit.
//
// Bound: device-memory writes of 12 bytes per pair (the reads are 32 bytes
// per Gaussian); the work per thread is the Gaussian's rect area, so a few
// screen-sized splats serialise in single threads.  This first version
// accepts that imbalance: on capture-like scenes such splats are ~0.1% of
// the scene and the sort after this kernel costs more.
#include "common.cuh"

__device__ __forceinline__ bool tile_hit(float px, float py, float r2, int tx, int ty) {
    const float fx = (float)(tx * TILE_EDGE);
    const float fy = (float)(ty * TILE_EDGE);
    const float cx = fminf(fmaxf(px, fx), __fadd_rn(fx, (float)(TILE_EDGE - 1)));
    const float cy = fminf(fmaxf(py, fy), __fadd_rn(fy, (float)(TILE_EDGE - 1)));
    const float ddx = __fsub_rn(cx, px);
    const float ddy = __fsub_rn(cy, py);
    return __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)) <= r2;
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

__global__ void write_pairs_kernel(const float* __restrict__ xy,
                                   const float* __restrict__ r_alpha_sq,
                                   const int* __restrict__ rect_min,
                                   const int* __restrict__ rect_max,
                                   const uint8_t* __restrict__ valid,
                                   const float* __restrict__ depth,
                                   const int64_t* __restrict__ offsets, int P,
                                   int circle_cull, int grid_w, int64_t* __restrict__ keys,
                                   int* __restrict__ gids) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= P || !valid[g]) return;
    const int x0 = rect_min[2 * g], y0 = rect_min[2 * g + 1];
    const int x1 = rect_max[2 * g], y1 = rect_max[2 * g + 1];
    const float px = xy[2 * g], py = xy[2 * g + 1], r2 = r_alpha_sq[g];
    const int64_t dbits = (int64_t)__float_as_uint(depth[g]);
    int64_t o = offsets[g];
    for (int ty = y0; ty < y1; ++ty) {
        for (int tx = x0; tx < x1; ++tx) {
            if (circle_cull && !tile_hit(px, py, r2, tx, ty)) continue;
            keys[o] = ((int64_t)(ty * grid_w + tx) << 32) | dbits;
            gids[o] = g;
            ++o;
        }
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
                                const void* rect_max, const void* valid, const void* depth,
                                const void* offsets, int P, int circle_cull, int grid_w,
                                void* keys, void* gids, void* stream) {
    if (P > 0) {
        const int threads = 256;
        write_pairs_kernel<<<(P + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
            (const float*)xy, (const float*)r_alpha_sq, (const int*)rect_min,
            (const int*)rect_max, (const uint8_t*)valid, (const float*)depth,
            (const int64_t*)offsets, P, circle_cull, grid_w, (int64_t*)keys,
            (int*)gids);
    }
    return (int)cudaGetLastError();
}
