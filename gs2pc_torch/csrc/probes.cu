// K3 and K4 -- the diagnostics probes: does a feature of the blend build,
// launch and compute the right value on this card?
//
// K3 replaces tools/pallas_probe.py::run (pl.pallas_call at :17) over its
// nine kernel bodies (:32-83): one (256, 128) float32 block, one op each --
//   0 row     column sums (over the 256 rows) broadcast down the rows, x x
//   1 repeat  row sums (over the 128 lanes) repeated across the lanes
//   2 mul     row sums x x
//   3 dot     row sums (x) ones(1, 128), the K = 1 outer product
//   4 roll    lane roll by 4, jnp.roll's direction: lane j moves to j + 4
//   5 concat  [row sum, row sum, row sum] in lanes 0-2, zeros after
//   6 slice   x + sum(x[:, 0])
//   7 min     x + min(x)
//   8 scan    inclusive product scan along the lanes, in the Hillis-Steele
//             log-step order of k_scan_fwd (acc *= lane < s ? 1 : acc[lane - s])
// Shape: one launch per op, a cluster of PROBE_OP_CTAS (8) CTAs of 128
// threads; CTA c holds rows 32c..32c+31, each warp 8 rows, each thread one
// float4 (4 adjacent lanes) of each of its rows in registers, loaded and
// stored once with 16-byte accesses.  A row is one warp: row sums are a
// warp butterfly, roll stores each float4 one slot on, and the scan walks
// k_scan_fwd's steps with __shfl_up_sync (lanes j - 1 and j - 2 partly in
// the thread, j - 4 .. j - 64 whole float4 from 1-16 threads down), so it
// makes the twin's multiplications in the twin's order.  The ops that
// reduce over rows (row, slice, min) combine the warps in shared memory
// and the 8 CTAs through distributed shared memory: each CTA publishes its
// partials, one cluster barrier, each reads all 8 in rank order.
//
// K4 replaces tools/pallas_probe2.py::try_level (pl.pallas_call at :158)
// over make_kernel(level) (:19-118): a stripped-down blend of 16 tiles of a
// 64x64 image, where each level adds one feature --
//   0 alpha = min(0.99, opacity exp(-dx^2 / 2)), ok = alpha >= 1/255 only,
//     t_before = 1 - a0 (not a transmittance)
//   1 the ok mask: power <= 0, alpha >= 1/255, lane < count, pixel not done
//   2 t_before = T x the exclusive lane product of (1 - a0) over the chunk
//   3 the stop trigger t_before (1 - alpha) < 1e-4 marks the pixel done
//     (the chunk's w is not masked by it: the TPU probe's own quirk)
//   4 T *= exp(sum log(1 - a0)) after every chunk
//   5 per pair (lane): the max over the tile's 256 pixels of w, and the
//     lowest pixel reaching it (when it is > 0; pixel 0 otherwise), written
//     to the (1, L) outputs m and apix at the chunk's columns
//   6 rgb = c_r + T bg on valid pixels, 0 elsewhere, in channel 0
//     (below 6, rgb is c_r on all three channels, unmasked)
// c_r and ed both add the chunk's sum of w; einv is ed unmasked.
// Shape: the TPU probe's (pixel, lane) layout with the lanes across the
// warp.  Thread t of a warp holds lanes t, t + 32, t + 64 and t + 96 of the
// chunk (x, opacity, alpha, a0, the scan: four registers each, read once
// per chunk from table rows 0 and 5), and the warp walks its pixels one by
// one.  A tile is a cluster of PROBE_BLEND_CTAS (8) CTAs of 16 warps, 128
// CTAs for the 16 tiles; CTA c takes pixels 32c..32c+31, warp w of it pixel
// 32c + 16i + w at step i (two steps), and lane i of the warp keeps that
// pixel's T, c_r, ed and done.  (Measured on the card, PERF.md: 1, 2 and 4
// CTAs per tile and 8 or 32 warps per CTA ran slower.)  Per pixel:
//   - the log-step scan in _lane_scan's order: for s = 1..16 the value at
//     lane j - s comes by __shfl_sync from thread t - s of the same segment
//     or thread t - s + 32 of the segment below (1.0 below lane 0); s = 32
//     and 64 are in the thread.  Each lane makes the twin's multiplication
//     in the twin's step;
//   - the lane sums in _lane_sum's pairs: h = 64 and 32 in the thread, then
//     a __shfl_xor_sync butterfly for h = 16..1, which leaves every thread
//     the twin's sum (each add is the twin's pair, operands swapped on the
//     upper half, and a + b == b + a);
//   - round-to-nearest intrinsics (no fused multiply-add) and accurate
//     expf / logf, alpha kept in registers for the stop trigger, which is
//     one __any_sync;
//   - at level >= 1 a done pixel is skipped: its ok is false on every lane,
//     so its w is 0, its sums add 0 and T is multiplied by exp(0) = 1, and
//     a w of 0 never wins the max below;
//   - the per-pair max: each thread keeps the best w of its four lanes and
//     the first pixel (its warp walks pixels in increasing order) that
//     strictly exceeds the running best, from (0, pixel 0).  At the end of
//     a chunk the warps fold the 64-bit key (float_bits(w) << 32) |
//     (0xFFFFFFFF - pixel) in shared memory (w >= 0, so the unsigned order
//     is the float order and ties go to the lowest pixel), and the 8 CTAs'
//     partials through distributed shared memory, each CTA writing 16 of
//     the chunk's 128 columns of m and apix.
// The all-done exit stays one test per chunk (a CTA's __syncthreads_and,
// then the cluster's flags after one barrier, double-buffered by chunk
// parity with the partials), so the chunks entered are the twin's.
//
// Bound: both move well under a megabyte per call (K3 256 KB in and out;
// K4 its chunks of two table rows, 16 x 256 x 5 floats out and m / apix)
// and K4 needs ~24 float operations per (pixel, lane) of a chunk it
// enters (chip_smoke.K4_FLOPS), so the H100 bound of each is well under a
// microsecond, below the time of a launch (probe_floor_kernel, an empty
// kernel, measures that floor).  Speed is not their point; agreement with
// the twin is.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define PROBE_FULL 0xffffffffu
#define PROBE_ROWS 256
#define PROBE_LANES 128
#define PROBE_SEGS (PROBE_LANES / 32)
#define PROBE_GRID_W 4
#define PROBE_WIDTH_PAD 64

// K3: a cluster of CTAs over the block's rows.
#define PROBE_OP_CTAS 8
#define PROBE_OP_THREADS 128
#define PROBE_OP_WARPS (PROBE_OP_THREADS / 32)
#define PROBE_OP_ROWS_CTA (PROBE_ROWS / PROBE_OP_CTAS)
#define PROBE_OP_ROWS_WARP (PROBE_OP_ROWS_CTA / PROBE_OP_WARPS)

// K4: a cluster of CTAs per tile, each over a share of its pixels.
#define PROBE_BLEND_CTAS 8
#define PROBE_BLEND_WARPS 16
#define PROBE_BLEND_THREADS (PROBE_BLEND_WARPS * 32)
#define PROBE_PX_CTA (TILE_PIXELS / PROBE_BLEND_CTAS)
#define PROBE_PX_WARP (PROBE_PX_CTA / PROBE_BLEND_WARPS)
#define PROBE_LANES_CTA (PROBE_LANES / PROBE_BLEND_CTAS)

static_assert(PROBE_OP_ROWS_WARP * PROBE_OP_WARPS * PROBE_OP_CTAS == PROBE_ROWS, "K3 rows");
static_assert(PROBE_PX_WARP >= 1 && PROBE_PX_WARP <= 32 &&
                  PROBE_PX_WARP * PROBE_BLEND_WARPS * PROBE_BLEND_CTAS == TILE_PIXELS,
              "K4: each lane keeps at most one pixel");

__device__ __forceinline__ float warp_sum_f32(float v) {
    for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(PROBE_FULL, v, off));
    return v;
}

__device__ __forceinline__ float warp_min_probe(float v) {
    for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(PROBE_FULL, v, off));
    return v;
}

// Arrive on / wait at the cluster barrier (the two halves of cluster.sync()).
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// k_scan_fwd over one row held as a float4 per thread (lanes 4l .. 4l + 3).
__device__ __forceinline__ float4 row_scan(float4 v, int l) {
    float a0 = v.x, a1 = v.y, a2 = v.z, a3 = v.w;
    {   // s = 1: lane 4l takes 4(l - 1) + 3 from the thread below.
        float u = __shfl_up_sync(PROBE_FULL, a3, 1);
        if (l == 0) u = 1.f;
        a3 = __fmul_rn(a3, a2);
        a2 = __fmul_rn(a2, a1);
        a1 = __fmul_rn(a1, a0);
        a0 = __fmul_rn(a0, u);
    }
    {   // s = 2: lanes 4l and 4l + 1 take 4(l - 1) + 2 and + 3.
        float u2 = __shfl_up_sync(PROBE_FULL, a2, 1);
        float u3 = __shfl_up_sync(PROBE_FULL, a3, 1);
        if (l == 0) u2 = u3 = 1.f;
        a3 = __fmul_rn(a3, a1);
        a2 = __fmul_rn(a2, a0);
        a1 = __fmul_rn(a1, u3);
        a0 = __fmul_rn(a0, u2);
    }
    // s = 4d for d = 1..16: the whole float4 of the thread d below.
    for (int d = 1; d < 32; d <<= 1) {
        const float u0 = __shfl_up_sync(PROBE_FULL, a0, d);
        const float u1 = __shfl_up_sync(PROBE_FULL, a1, d);
        const float u2 = __shfl_up_sync(PROBE_FULL, a2, d);
        const float u3 = __shfl_up_sync(PROBE_FULL, a3, d);
        if (l >= d) {
            a0 = __fmul_rn(a0, u0);
            a1 = __fmul_rn(a1, u1);
            a2 = __fmul_rn(a2, u2);
            a3 = __fmul_rn(a3, u3);
        }
    }
    return make_float4(a0, a1, a2, a3);
}

__global__ void __cluster_dims__(PROBE_OP_CTAS, 1, 1) __launch_bounds__(PROBE_OP_THREADS)
probe_op_kernel(int op, const float4* __restrict__ x, float4* __restrict__ out) {
    __shared__ __align__(16) float s_red[PROBE_OP_WARPS][PROBE_LANES];
    __shared__ float s_part[PROBE_LANES];  // this CTA's column sums, or its min in [0]
    __shared__ __align__(16) float s_all[PROBE_LANES];  // the block's, after the exchange
    const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
    const int row0 = blockIdx.x * PROBE_OP_ROWS_CTA + warp;
    float4 v[PROBE_OP_ROWS_WARP];
#pragma unroll
    for (int q = 0; q < PROBE_OP_ROWS_WARP; ++q)
        v[q] = x[(row0 + q * PROBE_OP_WARPS) * (PROBE_LANES / 4) + l];

    if (op == 0 || op == 6 || op == 7) {
        // Column sums (row: all 128; slice: column 0) or the min over the block.
        const int n = op == 0 ? PROBE_LANES : 1;
        if (op == 7) {
            float mn = fminf(fminf(v[0].x, v[0].y), fminf(v[0].z, v[0].w));
#pragma unroll
            for (int q = 1; q < PROBE_OP_ROWS_WARP; ++q)
                mn = fminf(mn, fminf(fminf(v[q].x, v[q].y), fminf(v[q].z, v[q].w)));
            mn = warp_min_probe(mn);
            if (l == 0) s_red[warp][0] = mn;
        } else {
            float4 cs = v[0];
#pragma unroll
            for (int q = 1; q < PROBE_OP_ROWS_WARP; ++q) {
                cs.x = __fadd_rn(cs.x, v[q].x);
                cs.y = __fadd_rn(cs.y, v[q].y);
                cs.z = __fadd_rn(cs.z, v[q].z);
                cs.w = __fadd_rn(cs.w, v[q].w);
            }
            reinterpret_cast<float4*>(s_red[warp])[l] = cs;
        }
        __syncthreads();
        if (threadIdx.x < n) {
            float a = s_red[0][threadIdx.x];
            for (int w = 1; w < PROBE_OP_WARPS; ++w)
                a = op == 7 ? fminf(a, s_red[w][threadIdx.x]) : __fadd_rn(a, s_red[w][threadIdx.x]);
            s_part[threadIdx.x] = a;
        }
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        if (threadIdx.x < n) {
            float a = cluster.map_shared_rank(s_part, 0)[threadIdx.x];
            for (int c = 1; c < PROBE_OP_CTAS; ++c) {
                const float b = cluster.map_shared_rank(s_part, c)[threadIdx.x];
                a = op == 7 ? fminf(a, b) : __fadd_rn(a, b);
            }
            s_all[threadIdx.x] = a;
        }
        // The other CTAs' partials are read; this CTA waits for its own
        // to be read before it exits.
        cluster_arrive();
        __syncthreads();
    }

#pragma unroll
    for (int q = 0; q < PROBE_OP_ROWS_WARP; ++q) {
        float4* o = out + (row0 + q * PROBE_OP_WARPS) * (PROBE_LANES / 4);
        const float4 a = v[q];
        float rs = 0.f;
        if (op == 1 || op == 2 || op == 3 || op == 5)
            rs = warp_sum_f32(__fadd_rn(__fadd_rn(a.x, a.y), __fadd_rn(a.z, a.w)));
        switch (op) {
            case 0: {
                const float4 c = reinterpret_cast<const float4*>(s_all)[l];
                o[l] = make_float4(__fmul_rn(c.x, a.x), __fmul_rn(c.y, a.y), __fmul_rn(c.z, a.z),
                                   __fmul_rn(c.w, a.w));
                break;
            }
            case 1: o[l] = make_float4(rs, rs, rs, rs); break;
            case 2:
                o[l] = make_float4(__fmul_rn(rs, a.x), __fmul_rn(rs, a.y), __fmul_rn(rs, a.z),
                                   __fmul_rn(rs, a.w));
                break;
            case 3: o[l] = make_float4(rs, rs, rs, rs); break;  // rs x 1 is rs
            case 4: o[(l + 1) & 31] = a; break;
            case 5: o[l] = l == 0 ? make_float4(rs, rs, rs, 0.f) : make_float4(0.f, 0.f, 0.f, 0.f); break;
            case 6:
            case 7: {
                const float c = s_all[0];
                o[l] = make_float4(__fadd_rn(a.x, c), __fadd_rn(a.y, c), __fadd_rn(a.z, c),
                                   __fadd_rn(a.w, c));
                break;
            }
            case 8: o[l] = row_scan(a, l); break;
            default: break;
        }
    }
    if (op == 0 || op == 6 || op == 7) cluster_wait();
}

GS2PC_API int gs2pc_probe_op(int op, const void* x, void* out, void* stream) {
    if (op < 0 || op > 8) return (int)cudaErrorInvalidValue;
    probe_op_kernel<<<PROBE_OP_CTAS, PROBE_OP_THREADS, 0, (cudaStream_t)stream>>>(
        op, (const float4*)x, (float4*)out);
    return (int)cudaGetLastError();
}

// The floor of a launch: an empty kernel, launched only by the timing tools.
__global__ void probe_floor_kernel() {}

GS2PC_API int gs2pc_probe_floor(void* stream) {
    probe_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

struct ProbeBlendParams {
    int level;
    const int* starts;      // (num_tiles,) first table column of the tile's run
    const int* counts;      // (num_tiles,) run length
    const int* dims;        // [width, height, num_tiles, bg]
    const float* table;     // (16, L) rows: 0 = x, 5 = opacity
    const uint8_t* mask;    // (num_tiles, 256) 0 = masked pixel
    int L;
    float* rgb;             // (num_tiles, 256, 3)
    float* ed;              // (num_tiles, 256)
    float* einv;            // (num_tiles, 256)
    float* m;               // (L,) per-pair max w (level >= 5), NaN-initialised
    int* apix;              // (L,) its pixel (level >= 5), -1-initialised
};

// _lane_scan over the chunk, v[k] holding lane 32k + t.
__device__ __forceinline__ void lane_scan4(float v[PROBE_SEGS], int t) {
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        float r[PROBE_SEGS];
#pragma unroll
        for (int k = 0; k < PROBE_SEGS; ++k) r[k] = __shfl_sync(PROBE_FULL, v[k], (t - s) & 31);
#pragma unroll
        for (int k = 0; k < PROBE_SEGS; ++k)
            v[k] = __fmul_rn(v[k], t >= s ? r[k] : (k > 0 ? r[k > 0 ? k - 1 : 0] : 1.f));
    }
    // s = 32 and 64: the segment one and two below, in this thread (top first).
    v[3] = __fmul_rn(v[3], v[2]);
    v[2] = __fmul_rn(v[2], v[1]);
    v[1] = __fmul_rn(v[1], v[0]);
    v[3] = __fmul_rn(v[3], v[1]);
    v[2] = __fmul_rn(v[2], v[0]);
}

// _lane_sum over the chunk, v[k] holding lane 32k + t; every thread gets it.
__device__ __forceinline__ float lane_sum4(const float v[PROBE_SEGS]) {
    float s = __fadd_rn(__fadd_rn(v[0], v[2]), __fadd_rn(v[1], v[3]));
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(PROBE_FULL, s, off));
    return s;
}

__device__ __forceinline__ unsigned long long probe_key(float w, int px) {
    return ((unsigned long long)__float_as_uint(w) << 32) | (unsigned long long)(0xFFFFFFFFu - (unsigned)px);
}

__global__ void __cluster_dims__(PROBE_BLEND_CTAS, 1, 1) __launch_bounds__(PROBE_BLEND_THREADS)
probe_blend_kernel(const ProbeBlendParams p) {
    __shared__ unsigned long long s_key[PROBE_BLEND_WARPS][PROBE_LANES];
    __shared__ unsigned long long s_part[2][PROBE_LANES];  // by chunk parity
    __shared__ int s_done[2];
    cg::cluster_group cluster = cg::this_cluster();
    const int t = blockIdx.x / PROBE_BLEND_CTAS, rank = blockIdx.x % PROBE_BLEND_CTAS;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tx = t % PROBE_GRID_W, ty = t / PROBE_GRID_W;
    const int width = p.dims[0], height = p.dims[1], num_tiles = p.dims[2];
    const float bg = (float)p.dims[3];
    const int start = p.starts[t], count = p.counts[t];
    const int n_chunks = count > 0 ? (count + PROBE_LANES - 1) / PROBE_LANES : 0;
    const float alpha_min = (float)(1.0 / 255.0);
    const int level = p.level;
    const int px0 = rank * PROBE_PX_CTA + warp;  // pixel of step i: px0 + i * warps

    // The pixel this lane keeps (lanes >= PROBE_PX_WARP keep none: done).
    const bool owner = lane < PROBE_PX_WARP;
    const int my_px = px0 + (owner ? lane : 0) * PROBE_BLEND_WARPS;
    const int my_gx = tx * TILE_EDGE + my_px % TILE_EDGE, my_gy = ty * TILE_EDGE + my_px / TILE_EDGE;
    const bool valid = owner && my_gx < width && my_gy < height && t < num_tiles &&
                       p.mask[t * TILE_PIXELS + my_px] != 0;
    float T = 1.f, c_r = 0.f, ed = 0.f;
    bool done = !valid;

    for (int r = 0;; ++r) {
        const int par = r & 1;
        const int cta_done = __syncthreads_and(done);
        if (threadIdx.x == 0) s_done[par] = cta_done;
        cluster.sync();
        bool all_done = true;
        for (int c = 0; c < PROBE_BLEND_CTAS; ++c)
            all_done = all_done && *cluster.map_shared_rank(&s_done[par], c);
        // The previous chunk's per-pair max: PROBE_LANES_CTA columns a CTA.
        if (level >= 5 && r > 0 && threadIdx.x < PROBE_LANES_CTA) {
            const int j = rank * PROBE_LANES_CTA + threadIdx.x;
            unsigned long long k = 0;
            for (int c = 0; c < PROBE_BLEND_CTAS; ++c) {
                const unsigned long long o = cluster.map_shared_rank(&s_part[par ^ 1][0], c)[j];
                k = o > k ? o : k;
            }
            const float mv = __uint_as_float((unsigned)(k >> 32));
            const int sb = mv > 0.f ? (int)(0xFFFFFFFFu - (unsigned)(k & 0xFFFFFFFFull)) : 0;
            const int col = start + (r - 1) * PROBE_LANES + j;
            p.m[col] = mv;
            p.apix[col] = (ty * TILE_EDGE + sb / TILE_EDGE) * PROBE_WIDTH_PAD + tx * TILE_EDGE +
                          sb % TILE_EDGE;
        }
        if (r >= n_chunks || all_done) break;

        const int base = start + r * PROBE_LANES;
        float xs[PROBE_SEGS], os[PROBE_SEGS], best_w[PROBE_SEGS];
        int best_px[PROBE_SEGS];
#pragma unroll
        for (int k = 0; k < PROBE_SEGS; ++k) {
            xs[k] = __ldg(p.table + base + 32 * k + lane);
            os[k] = __ldg(p.table + 5 * p.L + base + 32 * k + lane);
            best_w[k] = 0.f;
            best_px[k] = 0;
        }
        const int left = count - r * PROBE_LANES;  // lanes < left are in the run

        for (int i = 0; i < PROBE_PX_WARP; ++i) {
            if (level >= 1 && __shfl_sync(PROBE_FULL, (int)done, i)) continue;
            const int px = px0 + i * PROBE_BLEND_WARPS;
            const float pxf = (float)(tx * TILE_EDGE + px % TILE_EDGE);
            const float Tp = __shfl_sync(PROBE_FULL, T, i);
            float alpha[PROBE_SEGS], a0[PROBE_SEGS], acc[PROBE_SEGS], w[PROBE_SEGS];
            bool ok[PROBE_SEGS];
#pragma unroll
            for (int k = 0; k < PROBE_SEGS; ++k) {
                const float dx = pxf - xs[k];
                const float power = __fmul_rn(__fmul_rn(-0.5f, dx), dx);
                alpha[k] = fminf(0.99f, __fmul_rn(os[k], expf(power)));
                ok[k] = level >= 1 ? (power <= 0.f && alpha[k] >= alpha_min && 32 * k + lane < left)
                                   : alpha[k] >= alpha_min;
                a0[k] = ok[k] ? alpha[k] : 0.f;
                acc[k] = 1.f - a0[k];
            }
            bool trig = false;
            if (level >= 2) {
                lane_scan4(acc, lane);
                float r1[PROBE_SEGS];
#pragma unroll
                for (int k = 0; k < PROBE_SEGS; ++k) r1[k] = __shfl_sync(PROBE_FULL, acc[k], (lane - 1) & 31);
#pragma unroll
                for (int k = 0; k < PROBE_SEGS; ++k) {
                    const float excl = lane >= 1 ? r1[k] : (k > 0 ? r1[k > 0 ? k - 1 : 0] : 1.f);
                    const float t_before = __fmul_rn(Tp, excl);
                    if (level >= 3 && ok[k] && __fmul_rn(t_before, 1.f - alpha[k]) < 1e-4f) trig = true;
                    w[k] = __fmul_rn(a0[k], t_before);
                }
            } else {
#pragma unroll
                for (int k = 0; k < PROBE_SEGS; ++k) w[k] = __fmul_rn(a0[k], acc[k]);
            }
            const bool stop = __any_sync(PROBE_FULL, trig);
            if (level >= 5) {
#pragma unroll
                for (int k = 0; k < PROBE_SEGS; ++k)
                    if (w[k] > best_w[k]) {
                        best_w[k] = w[k];
                        best_px[k] = px;
                    }
            }
            const float wsum = lane_sum4(w);
            float Tn = Tp;
            if (level >= 4) {
                float lg[PROBE_SEGS];
#pragma unroll
                for (int k = 0; k < PROBE_SEGS; ++k) lg[k] = logf(1.f - a0[k]);
                Tn = __fmul_rn(Tp, expf(lane_sum4(lg)));
            }
            if (lane == i) {
                c_r = __fadd_rn(c_r, wsum);
                ed = __fadd_rn(ed, wsum);
                T = Tn;
                done = done || stop;
            }
        }

        if (level >= 5) {
#pragma unroll
            for (int k = 0; k < PROBE_SEGS; ++k) s_key[warp][32 * k + lane] = probe_key(best_w[k], best_px[k]);
            __syncthreads();
            if (threadIdx.x < PROBE_LANES) {
                unsigned long long k = s_key[0][threadIdx.x];
                for (int wi = 1; wi < PROBE_BLEND_WARPS; ++wi) {
                    const unsigned long long o = s_key[wi][threadIdx.x];
                    k = o > k ? o : k;
                }
                s_part[par][threadIdx.x] = k;
            }
            // The next iteration's __syncthreads_and (and cluster barrier)
            // publishes s_part and frees s_key.
        }
    }
    // No CTA leaves while another may still read its shared memory.
    cluster.sync();

    if (owner) {
        const int o = t * TILE_PIXELS + my_px;
        float* rgb = p.rgb + (size_t)o * 3;
        if (level >= 6) {
            rgb[0] = valid ? __fadd_rn(c_r, __fmul_rn(T, bg)) : 0.f;
            rgb[1] = valid ? c_r : 0.f;
            rgb[2] = valid ? c_r : 0.f;
        } else {
            rgb[0] = rgb[1] = rgb[2] = c_r;
        }
        p.ed[o] = valid ? ed : 0.f;
        p.einv[o] = ed;
    }
}

GS2PC_API int gs2pc_probe_blend(int level, int num_tiles, const void* starts, const void* counts,
                                const void* dims, const void* table, const void* mask, int L,
                                void* rgb, void* ed, void* einv, void* m, void* apix,
                                void* stream) {
    ProbeBlendParams prm;
    prm.level = level;
    prm.starts = (const int*)starts;
    prm.counts = (const int*)counts;
    prm.dims = (const int*)dims;
    prm.table = (const float*)table;
    prm.mask = (const uint8_t*)mask;
    prm.L = L;
    prm.rgb = (float*)rgb;
    prm.ed = (float*)ed;
    prm.einv = (float*)einv;
    prm.m = (float*)m;
    prm.apix = (int*)apix;
    if (num_tiles > 0)
        probe_blend_kernel<<<num_tiles * PROBE_BLEND_CTAS, PROBE_BLEND_THREADS, 0,
                             (cudaStream_t)stream>>>(prm);
    return (int)cudaGetLastError();
}
