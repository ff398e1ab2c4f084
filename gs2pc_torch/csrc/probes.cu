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
// Shape: one block per row of 128 lanes, one thread per lane.  Row sums
// are warp shuffles plus a shared-memory combine of the 4 warps.  The ops
// that reduce over rows (row, slice, min) first run probe_colreduce_kernel:
// one block of 128 threads, each walking its column top to bottom.  The
// lane scan walks the log steps in shared memory, so kernel and twin agree
// bit for bit.
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
// Shape: one block per tile (16), one thread per pixel (256).  Each chunk's
// 128 columns of table rows 0 (x) and 5 (opacity) are staged in shared
// memory (the TPU kernel's make_async_copy into buf_ref); the loop runs
// while chunks remain and not every pixel is done, tested once per chunk
// with __syncthreads_and.  Each thread keeps its pixel's 128 lanes in
// local memory and walks the log-step scan over them in JAX's order.  The
// lane sums are pairwise with round-to-nearest intrinsics (no fused
// multiply-add), in the twin's order, so the two agree bit for bit wherever
// expf and logf do.  The per-pair max and argmax reduce the 64-bit key
//     (float_bits(w) << 32) | (0xFFFFFFFF - pixel)
// (w >= 0) with warp shuffles and a shared-memory combine of the 8 warps.
//
// Bound: both move well under a megabyte per call (K3 256 KB in and out;
// K4 its chunks of two table rows, 16 x 256 x 5 floats out and m / apix)
// and K4 needs ~24 float operations per (pixel, lane) of a chunk it
// enters (chip_smoke.K4_FLOPS), so the H100 bound is well under a
// microsecond for each.  K3 takes launch latency.  K4 takes longer: each
// of its 16 x 256 threads keeps two 128-float lane arrays in local memory
// and makes seven log-step passes over them per chunk.  Speed is not their
// point; agreement with the twin is.
#include <float.h>

#include "common.cuh"

#define PROBE_ROWS 256
#define PROBE_LANES 128
#define PROBE_WARPS_OP (PROBE_LANES / 32)
#define PROBE_GRID_W 4
#define PROBE_WIDTH_PAD 64
#define PROBE_WARPS_BLEND (TILE_PIXELS / 32)

__device__ __forceinline__ float warp_sum_f32(float v) {
    for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ float warp_min_probe(float v) {
    for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long v) {
    for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
        v = o > v ? o : v;
    }
    return v;
}

// Sum of a thread's 128 lanes, pairwise: lane j adds lane j + h for
// h = 64, 32, ..., 1 (the twin's order).  Overwrites v.
__device__ __forceinline__ float lane_sum(float* v) {
    for (int h = PROBE_LANES / 2; h >= 1; h >>= 1)
        for (int j = 0; j < h; ++j) v[j] = __fadd_rn(v[j], v[j + h]);
    return v[0];
}

// Column sums and minima of x, one thread per column.
__global__ void __launch_bounds__(PROBE_LANES)
probe_colreduce_kernel(const float* __restrict__ x, float* __restrict__ colsum,
                       float* __restrict__ colmin) {
    const int j = threadIdx.x;
    float s = 0.f, mn = x[j];
    for (int i = 0; i < PROBE_ROWS; ++i) {
        const float v = x[i * PROBE_LANES + j];
        s = __fadd_rn(s, v);
        mn = fminf(mn, v);
    }
    colsum[j] = s;
    colmin[j] = mn;
}

__global__ void __launch_bounds__(PROBE_LANES)
probe_op_kernel(int op, const float* __restrict__ x, const float* __restrict__ colsum,
                const float* __restrict__ colmin, float* __restrict__ out) {
    __shared__ float s_red[PROBE_WARPS_OP];
    __shared__ float s_acc[PROBE_LANES];
    const int i = blockIdx.x, j = threadIdx.x;
    const int warp = j >> 5, lane = j & 31;
    const float v = x[i * PROBE_LANES + j];
    float* o = out + i * PROBE_LANES;

    // Row sum (ops 1, 2, 3, 5) or global min (op 7): warps, then 4 partials.
    float red = 0.f;
    if (op == 1 || op == 2 || op == 3 || op == 5) {
        const float ws = warp_sum_f32(v);
        if (lane == 0) s_red[warp] = ws;
        __syncthreads();
        red = __fadd_rn(__fadd_rn(s_red[0], s_red[1]), __fadd_rn(s_red[2], s_red[3]));
    } else if (op == 7) {
        const float wm = warp_min_probe(colmin[j]);
        if (lane == 0) s_red[warp] = wm;
        __syncthreads();
        red = fminf(fminf(s_red[0], s_red[1]), fminf(s_red[2], s_red[3]));
    }

    switch (op) {
        case 0: o[j] = __fmul_rn(colsum[j], v); break;
        case 1: o[j] = red; break;
        case 2: o[j] = __fmul_rn(red, v); break;
        case 3: o[j] = __fmul_rn(red, 1.f); break;
        case 4: o[(j + 4) % PROBE_LANES] = v; break;
        case 5: o[j] = j < 3 ? red : 0.f; break;
        case 6: o[j] = __fadd_rn(v, colsum[0]); break;
        case 7: o[j] = __fadd_rn(v, red); break;
        case 8: {
            s_acc[j] = v;
            for (int s = 1; s < PROBE_LANES; s *= 2) {
                __syncthreads();
                const float prev = j >= s ? s_acc[j - s] : 1.f;
                __syncthreads();
                s_acc[j] = __fmul_rn(s_acc[j], prev);
            }
            o[j] = s_acc[j];
            break;
        }
        default: break;
    }
}

GS2PC_API int gs2pc_probe_op(int op, const void* x, void* scratch, void* out, void* stream) {
    if (op < 0 || op > 8) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    float* colsum = (float*)scratch;
    float* colmin = colsum + PROBE_LANES;
    if (op == 0 || op == 6 || op == 7) {
        probe_colreduce_kernel<<<1, PROBE_LANES, 0, st>>>((const float*)x, colsum, colmin);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    probe_op_kernel<<<PROBE_ROWS, PROBE_LANES, 0, st>>>(op, (const float*)x, colsum, colmin,
                                                        (float*)out);
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

__global__ void __launch_bounds__(TILE_PIXELS) probe_blend_kernel(const ProbeBlendParams p) {
    __shared__ float s_x[PROBE_LANES];
    __shared__ float s_o[PROBE_LANES];
    __shared__ unsigned long long s_key[PROBE_WARPS_BLEND * PROBE_LANES];
    const int t = blockIdx.x, s = threadIdx.x;
    const int warp = s >> 5, lane_id = s & 31;
    const int tx = t % PROBE_GRID_W, ty = t / PROBE_GRID_W;
    const int gx = tx * TILE_EDGE + s % TILE_EDGE;
    const int gy = ty * TILE_EDGE + s / TILE_EDGE;
    const float pxf = (float)gx;
    const int width = p.dims[0], height = p.dims[1], num_tiles = p.dims[2];
    const float bg = (float)p.dims[3];
    const bool valid = gx < width && gy < height && t < num_tiles && p.mask[t * TILE_PIXELS + s] != 0;
    const int start = p.starts[t], count = p.counts[t];
    const int n_chunks = count > 0 ? (count + PROBE_LANES - 1) / PROBE_LANES : 0;
    const float alpha_min = (float)(1.0 / 255.0);
    const int level = p.level;

    float a0[PROBE_LANES];   // a0 per lane; ok <=> a0 > 0
    float acc[PROBE_LANES];  // the lane scan, then w
    float T = 1.f, c_r = 0.f, ed = 0.f;
    bool done = !valid;
    for (int r = 0; r < n_chunks && !__syncthreads_and(done); ++r) {
        const int base = start + r * PROBE_LANES;
        if (s < PROBE_LANES) s_x[s] = p.table[base + s];
        else s_o[s - PROBE_LANES] = p.table[5 * p.L + base + s - PROBE_LANES];
        __syncthreads();

        for (int j = 0; j < PROBE_LANES; ++j) {
            const float dx = pxf - s_x[j];
            const float power = __fmul_rn(__fmul_rn(-0.5f, dx), dx);
            const float alpha = fminf(0.99f, __fmul_rn(s_o[j], expf(power)));
            const bool ok = level >= 1
                ? (power <= 0.f && alpha >= alpha_min && r * PROBE_LANES + j < count && !done)
                : alpha >= alpha_min;
            a0[j] = ok ? alpha : 0.f;
            acc[j] = 1.f - a0[j];
        }
        if (level >= 2) {
            for (int st = 1; st < PROBE_LANES; st *= 2)
                for (int j = PROBE_LANES - 1; j >= st; --j) acc[j] = __fmul_rn(acc[j], acc[j - st]);
            // acc becomes w, top lane first, so acc[j - 1] is still the scan.
            for (int j = PROBE_LANES - 1; j >= 0; --j) {
                const float t_before = __fmul_rn(T, j >= 1 ? acc[j - 1] : 1.f);
                if (level >= 3 && a0[j] > 0.f) {
                    const float dx = pxf - s_x[j];
                    const float power = __fmul_rn(__fmul_rn(-0.5f, dx), dx);
                    const float alpha = fminf(0.99f, __fmul_rn(s_o[j], expf(power)));
                    if (__fmul_rn(t_before, 1.f - alpha) < 1e-4f) done = true;
                }
                acc[j] = __fmul_rn(a0[j], t_before);
            }
        } else {
            for (int j = 0; j < PROBE_LANES; ++j) acc[j] = __fmul_rn(a0[j], acc[j]);
        }
        if (level >= 5) {
            for (int j = 0; j < PROBE_LANES; ++j) {
                const unsigned long long key =
                    ((unsigned long long)__float_as_uint(acc[j]) << 32) |
                    (unsigned long long)(0xFFFFFFFFu - (unsigned)s);
                const unsigned long long k = warp_max_key(key);
                if (lane_id == 0) s_key[warp * PROBE_LANES + j] = k;
            }
            __syncthreads();
            if (s < PROBE_LANES) {
                unsigned long long k = s_key[s];
                for (int wi = 1; wi < PROBE_WARPS_BLEND; ++wi) {
                    const unsigned long long o = s_key[wi * PROBE_LANES + s];
                    k = o > k ? o : k;
                }
                const float mv = __uint_as_float((unsigned)(k >> 32));
                const int sb = mv > 0.f ? (int)(0xFFFFFFFFu - (unsigned)(k & 0xFFFFFFFFull)) : 0;
                p.m[base + s] = mv;
                p.apix[base + s] =
                    (ty * TILE_EDGE + sb / TILE_EDGE) * PROBE_WIDTH_PAD + tx * TILE_EDGE + sb % TILE_EDGE;
            }
        }
        // The lane sums consume acc (w) and a0 in place.
        const float wsum = lane_sum(acc);
        c_r = __fadd_rn(c_r, wsum);
        ed = __fadd_rn(ed, wsum);
        if (level >= 4) {
            for (int j = 0; j < PROBE_LANES; ++j) a0[j] = logf(1.f - a0[j]);
            T = __fmul_rn(T, expf(lane_sum(a0)));
        }
        // The loop test's __syncthreads_and also frees s_x / s_o / s_key.
    }

    float* rgb = p.rgb + (size_t)(t * TILE_PIXELS + s) * 3;
    if (level >= 6) {
        rgb[0] = valid ? __fadd_rn(c_r, __fmul_rn(T, bg)) : 0.f;
        rgb[1] = valid ? c_r : 0.f;
        rgb[2] = valid ? c_r : 0.f;
    } else {
        rgb[0] = rgb[1] = rgb[2] = c_r;
    }
    p.ed[t * TILE_PIXELS + s] = valid ? ed : 0.f;
    p.einv[t * TILE_PIXELS + s] = ed;
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
        probe_blend_kernel<<<num_tiles, TILE_PIXELS, 0, (cudaStream_t)stream>>>(prm);
    return (int)cudaGetLastError();
}
