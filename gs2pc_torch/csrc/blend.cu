// K1 -- tile blend with fused per-Gaussian reductions.
//
// Replaces: gs2pc/ops/pallas_blend.py::_blend_kernel (:261-673, launched by
// pallas_blend's pl.pallas_call at :808) together with the per-Gaussian
// windowed scatter reductions that follow it, gs2pc/ops/rasterize.py::
// _pair_reduce (:1014) and _sd_reduce (:986), in all four of its modes.
//
// Modes (the last three serve the depth-slab renderer,
// gs2pc_torch/parallel/gauss_shard.py; each is one pass per slab):
//   main         T starts at 1, the T*(1-alpha) < 1e-4 stop fires, every
//                tile leaves at its all-done chunk.
//   early_stop=0 (pass 1) the stop never fires: every ok pair blends and T
//                is the exact product over the run, so the all-done exit
//                never fires on a tile with a valid pixel and the tile walks
//                its whole capped run -- the costly mode.
//   init_trans   (pass 2, and pass 3) T starts at the pixel's value in a
//                (Hp*Wp,) map (the upstream slabs' product); a pixel whose
//                start is already below 1e-4 stops on its first ok pair and
//                blends nothing, which reproduces the single-device stop.
//                Costs one 4-byte load per pixel.
//   ed_override  (pass 3) the surface pass measures |depth - map[pixel]|
//                (the combined expected depth of all slabs) instead of the
//                tile's own; chunk counts and surface_compact are unchanged.
//                Costs one 4-byte load per pixel.
// The background bg is an argument: the slab passes render with 0 and the
// caller adds the background once from the combined T.
//
// Shape, as in the reference's renderCUDA: one CTA per 16x16 tile, one
// thread per pixel.  The tile's depth-sorted pair run is walked in chunks
// of run_chunk pairs; each chunk's per-Gaussian rows are staged in shared
// memory and every thread blends them front to back, sequentially, with
// the exact alpha / early-stop rules of gs2pc.ops.blend.  The blend's
// arithmetic is written with round-to-nearest intrinsics, so nvcc fuses no
// multiply-add: the PyTorch twin repeats the same operations in the same
// order and a stop decision (T * (1 - alpha) < 1e-4) cannot flip between
// the two on one pixel, which would change it by up to alpha * T.  The all-done
// test runs once per chunk, so the number of chunks entered (r_fin) is the
// JAX kernel's and the surface pass of surface_compact mode covers the same
// pairs.  r_fin is also written per tile (chunks), so a caller can count
// the pairs the blend streamed.
//
// Per-pair reductions happen in the epilogue of each chunk instead of a
// separate scatter pass: per pair, a warp-shuffle max and a shared-memory
// combine of the 8 warps reduce the 64-bit key
//     (float_bits(w) << 32) | (0xFFFFFFFF - padded_pixel_id)
// over the tile's pixels, and one atomicMax per (pair, tile) with w > 0
// folds it into the Gaussian's key.  The max key carries the max
// contribution and, among exact ties, the lowest padded pixel id -- the
// deterministic rule of the JAX exact path (rasterize.py:1103-1143).  The
// surface pass is a second walk over the same run: per pair the min over
// valid pixels of |depth - expected depth|, folded with an integer
// atomicMin on the non-negative float bits.
//
// Bound: per streamed (pair, pixel) ~30 flops and one expf, plus 64-bit
// shuffles per pair per warp; on capture-like scenes most tiles stop after
// a few chunks, except in the early_stop=0 mode, which streams every pair.
// This first version is latency-bound by the sequential per-pair loop and
// the per-pair reductions; batching the key reduction and double-buffering
// the staging are later work.
#include <float.h>

#include "common.cuh"

#define NUM_WARPS (TILE_PIXELS / 32)

struct BlendParams {
    const float* table;      // (P, table_lanes) per-Gaussian rows, original order
    const int* sorted_gid;   // (L,) Gaussian id per depth-sorted pair
    const int* starts;       // (num_tiles,) run start in the sorted pairs
    const int* counts;       // (num_tiles,) capped run length (0 = skip tile)
    const uint8_t* mask;     // (Hp * Wp,) 0 = masked pixel, or nullptr
    const float* init_trans; // (Hp * Wp,) starting T per pixel, or nullptr (1)
    const float* ed_override;// (Hp * Wp,) surface-pass depth target, or nullptr
    int early_stop;          // 0: the T < 1e-4 stop never fires
    int table_lanes;         // 8 (compact rgb24) or 16
    int width, height;       // true image size
    int grid_w, width_pad;   // tiles per row, padded row length in pixels
    int run_chunk;           // pairs per staged chunk
    float bg;                // background (1 = white)
    int with_surface, surface_compact;
    float* image;            // (Hp * Wp, 3)
    float* depth;            // (Hp * Wp,)
    float* invdepth;
    float* trans;
    float* live;
    int* chunks;             // (num_tiles,) chunks the blend entered (r_fin)
    unsigned long long* contrib_key;  // (P,) zero-initialised
    int* surf_bits;          // (P,) float bits, FLT_MAX-initialised
};

__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long v) {
    for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
        v = o > v ? o : v;
    }
    return v;
}

__device__ __forceinline__ float warp_min_f32(float v) {
    for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__global__ void __launch_bounds__(TILE_PIXELS) blend_tiles_kernel(const BlendParams p) {
    const int Rs = p.run_chunk;
    // Shared layout: keys first (8-byte aligned), then the staged chunk.
    extern __shared__ unsigned long long smem_u64[];
    unsigned long long* s_key = smem_u64;              // NUM_WARPS * Rs
    float* s_sd = (float*)(s_key + NUM_WARPS * Rs);    // NUM_WARPS * Rs
    float* s_x = s_sd + NUM_WARPS * Rs;
    float* s_y = s_x + Rs;
    float* s_a = s_y + Rs;
    float* s_b = s_a + Rs;
    float* s_c = s_b + Rs;
    float* s_o = s_c + Rs;
    float* s_d = s_o + Rs;
    float* s_id = s_d + Rs;
    float* s_r = s_id + Rs;
    float* s_g = s_r + Rs;
    float* s_bl = s_g + Rs;
    int* s_gid = (int*)(s_bl + Rs);

    const int tile = blockIdx.x;
    const int tx = tile % p.grid_w, ty = tile / p.grid_w;
    const int lid = threadIdx.x;
    const int warp = lid >> 5, lane = lid & 31;
    const int gx = tx * TILE_EDGE + (lid % TILE_EDGE);
    const int gy = ty * TILE_EDGE + (lid / TILE_EDGE);
    const int pix = gy * p.width_pad + gx;
    const bool valid =
        gx < p.width && gy < p.height && (p.mask == nullptr || p.mask[pix] != 0);
    const float pxf = (float)gx, pyf = (float)gy;

    float T = p.init_trans != nullptr ? p.init_trans[pix] : 1.f;
    float cr = 0.f, cg = 0.f, cb = 0.f, ed = 0.f, einv = 0.f;
    bool done = !valid;

    const int start = p.starts[tile];
    const int count = p.counts[tile];
    const int n_chunks = (count + Rs - 1) / Rs;
    const float alpha_min = (float)(1.0 / 255.0);
    const float inv255 = (float)(1.0 / 255.0);

    int r_fin = 0;
    bool all_done = __syncthreads_and(done);
    for (int r = 0; r < n_chunks && !all_done; ++r) {
        r_fin = r + 1;
        const int base = start + r * Rs;
        const int n = min(Rs, count - r * Rs);
        for (int j = lid; j < n; j += TILE_PIXELS) {
            const int g = p.sorted_gid[base + j];
            const float* row = p.table + (size_t)g * p.table_lanes;
            s_gid[j] = g;
            s_x[j] = row[0];
            s_y[j] = row[1];
            s_a[j] = row[2];
            s_b[j] = row[3];
            s_c[j] = row[4];
            s_o[j] = row[5];
            const float d = row[6];
            s_d[j] = d;
            s_id[j] = 1.f / (fabsf(d) < 1e-12f ? 1e-12f : d);
            if (p.table_lanes == 8) {
                const int v = (int)row[7];
                s_r[j] = (float)((v >> 16) & 255) * inv255;
                s_g[j] = (float)((v >> 8) & 255) * inv255;
                s_bl[j] = (float)(v & 255) * inv255;
            } else {
                s_r[j] = row[8];
                s_g[j] = row[9];
                s_bl[j] = row[10];
            }
        }
        __syncthreads();

        for (int j = 0; j < n; ++j) {
            float w = 0.f;
            if (!done) {
                const float dx = pxf - s_x[j];
                const float dy = pyf - s_y[j];
                const float power = __fsub_rn(
                    __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(s_a[j], dx), dx),
                                               __fmul_rn(__fmul_rn(s_c[j], dy), dy))),
                    __fmul_rn(__fmul_rn(s_b[j], dx), dy));
                if (power <= 0.f) {
                    const float alpha = fminf(0.99f, __fmul_rn(s_o[j], expf(power)));
                    if (alpha >= alpha_min) {
                        const float test_T = __fmul_rn(T, 1.f - alpha);
                        if (p.early_stop && test_T < 1e-4f) {
                            done = true;
                        } else {
                            w = __fmul_rn(alpha, T);
                            cr = __fadd_rn(cr, __fmul_rn(w, s_r[j]));
                            cg = __fadd_rn(cg, __fmul_rn(w, s_g[j]));
                            cb = __fadd_rn(cb, __fmul_rn(w, s_bl[j]));
                            ed = __fadd_rn(ed, __fmul_rn(w, s_d[j]));
                            einv = __fadd_rn(einv, __fmul_rn(w, s_id[j]));
                            T = test_T;
                        }
                    }
                }
            }
            unsigned long long key = 0ull;
            if (w > 0.f)
                key = ((unsigned long long)__float_as_uint(w) << 32) |
                      (unsigned long long)(0xFFFFFFFFu - (unsigned)pix);
            if (__any_sync(0xffffffffu, key != 0ull)) key = warp_max_u64(key);
            if (lane == 0) s_key[warp * Rs + j] = key;
        }
        __syncthreads();

        for (int j = lid; j < n; j += TILE_PIXELS) {
            unsigned long long k = s_key[j];
            for (int wi = 1; wi < NUM_WARPS; ++wi) {
                const unsigned long long o = s_key[wi * Rs + j];
                k = o > k ? o : k;
            }
            if (k != 0ull) atomicMax(&p.contrib_key[s_gid[j]], k);
        }
        // Also the barrier that frees the staging buffers for the next chunk.
        all_done = __syncthreads_and(done);
    }

    const float tbg = __fmul_rn(T, p.bg);
    p.image[3 * pix + 0] = valid ? __fadd_rn(cr, tbg) : 0.f;
    p.image[3 * pix + 1] = valid ? __fadd_rn(cg, tbg) : 0.f;
    p.image[3 * pix + 2] = valid ? __fadd_rn(cb, tbg) : 0.f;
    p.depth[pix] = valid ? ed : 0.f;
    p.invdepth[pix] = valid ? einv : 0.f;
    p.trans[pix] = valid ? T : 1.f;
    p.live[pix] = (valid && !done) ? T : 0.f;
    if (lid == 0) p.chunks[tile] = r_fin;

    if (!p.with_surface) return;
    // Surface pass: min over valid pixels of |pair depth - expected depth|,
    // over the chunks the blend streamed (surface_compact) or the whole run.
    const int n_surf = p.surface_compact ? r_fin : n_chunks;
    const float ed_target = p.ed_override != nullptr ? p.ed_override[pix] : ed;
    for (int r = 0; r < n_surf; ++r) {
        const int base = start + r * Rs;
        const int n = min(Rs, count - r * Rs);
        for (int j = lid; j < n; j += TILE_PIXELS) {
            const int g = p.sorted_gid[base + j];
            s_gid[j] = g;
            s_d[j] = p.table[(size_t)g * p.table_lanes + 6];
        }
        __syncthreads();
        for (int j = 0; j < n; ++j) {
            float dist = valid ? fabsf(s_d[j] - ed_target) : FLT_MAX;
            dist = warp_min_f32(dist);
            if (lane == 0) s_sd[warp * Rs + j] = dist;
        }
        __syncthreads();
        for (int j = lid; j < n; j += TILE_PIXELS) {
            float v = s_sd[j];
            for (int wi = 1; wi < NUM_WARPS; ++wi) v = fminf(v, s_sd[wi * Rs + j]);
            if (v < FLT_MAX) atomicMin(&p.surf_bits[s_gid[j]], __float_as_int(v));
        }
        __syncthreads();
    }
}

static size_t blend_smem_bytes(int run_chunk) {
    return (size_t)NUM_WARPS * run_chunk * (sizeof(unsigned long long) + sizeof(float)) +
           (size_t)run_chunk * (11 * sizeof(float) + sizeof(int));
}

GS2PC_API int gs2pc_blend_tiles(const void* table, const void* sorted_gid, const void* starts,
                                const void* counts, const void* mask, const void* init_trans,
                                const void* ed_override, int early_stop, int table_lanes,
                                int num_tiles, int width, int height, int grid_w,
                                int width_pad, int run_chunk, float bg, int with_surface,
                                int surface_compact, void* image, void* depth,
                                void* invdepth, void* trans, void* live, void* chunks,
                                void* contrib_key, void* surf_bits, void* stream) {
    BlendParams prm;
    prm.table = (const float*)table;
    prm.sorted_gid = (const int*)sorted_gid;
    prm.starts = (const int*)starts;
    prm.counts = (const int*)counts;
    prm.mask = (const uint8_t*)mask;
    prm.init_trans = (const float*)init_trans;
    prm.ed_override = (const float*)ed_override;
    prm.early_stop = early_stop;
    prm.table_lanes = table_lanes;
    prm.width = width;
    prm.height = height;
    prm.grid_w = grid_w;
    prm.width_pad = width_pad;
    prm.run_chunk = run_chunk;
    prm.bg = bg;
    prm.with_surface = with_surface;
    prm.surface_compact = surface_compact;
    prm.image = (float*)image;
    prm.depth = (float*)depth;
    prm.invdepth = (float*)invdepth;
    prm.trans = (float*)trans;
    prm.live = (float*)live;
    prm.chunks = (int*)chunks;
    prm.contrib_key = (unsigned long long*)contrib_key;
    prm.surf_bits = (int*)surf_bits;
    const size_t smem = blend_smem_bytes(run_chunk);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            blend_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (num_tiles > 0)
        blend_tiles_kernel<<<num_tiles, TILE_PIXELS, smem, (cudaStream_t)stream>>>(prm);
    return (int)cudaGetLastError();
}
