// K1 -- tile blend with fused per-Gaussian reductions, laid out for Hopper.
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
//   ed_override  (pass 3) the surface pass measures |depth - map[pixel]|
//                (the combined expected depth of all slabs) instead of the
//                tile's own; chunk counts and surface_compact are unchanged.
// The background bg is an argument: the slab passes render with 0 and the
// caller adds the background once from the combined T.
//
// Semantics, as in the reference's renderCUDA: one thread per pixel of a
// 16x16 tile walks the tile's depth-sorted pair run front to back in chunks
// of run_chunk pairs, with the exact alpha / early-stop rules of
// gs2pc.ops.blend.  The blend's arithmetic is written with round-to-nearest
// intrinsics and accurate expf, so nvcc fuses no multiply-add and the
// PyTorch twin, which repeats the same operations in the same order, agrees
// to the bit: a stop decision (T * (1 - alpha) < 1e-4) cannot flip between
// the two.  The all-done test runs once per chunk, so the number of chunks
// entered (r_fin, written per tile to chunks) is the JAX kernel's and the
// surface pass of surface_compact mode covers the same pairs.
//
// Per-Gaussian results are order-independent atomics, so the tile order
// and the block a tile lands on change no bit: per (pair, tile) one 64-bit
// atomicMax of (float_bits(w) << 32) | (0xFFFFFFFF - padded_pixel_id), the
// max contribution and among exact ties the lowest padded pixel (the JAX
// exact path's rule, rasterize.py:1103-1143); per (pair, tile) one atomicMin
// of the surface distance's non-negative float bits.
//
// What bounds it: per streamed (pair, pixel) ~30 flops and one expf on a
// sequential per-pixel dependency chain (T), at 256 pixels per tile; the
// bytes (gids, 32-byte table rows, images) are a few percent of the time,
// and the issue slots of the per-pair loop set the pace.  So the design
// takes instructions out of that loop and keeps it fed:
//   1. Per-pair max: one redux.sync (__reduce_max_sync) on the bits of w
//      (w >= 0, so the unsigned order is the float order), one ballot of
//      the lanes that reach it and __ffs for the lowest lane; the lane order
//      is the padded-pixel order (one warp = two 16-pixel rows of the tile).
//      This replaces five rounds of 64-bit shuffles.  A warp whose pixels
//      are all done skips the rest of the chunk (s_wn counts the pairs it
//      reduced); the 8 warps are combined in shared memory, one atomicMax
//      per (pair, tile) with w > 0.
//   1b. Warp cull: each staged pair carries the pixel box outside which its
//      alpha stays below 1/255 (alpha_box); a warp whose 16x2 pixels lie
//      outside it skips the pair (w = 0 on every lane, as the blend would
//      give).  The rect of a pair covers the whole tile, the box often
//      only a few of its warps.
//   2. Staging: chunk r+1's raw table rows are copied into shared memory
//      with 16-byte cp.async while chunk r blends; each thread stages and
//      decodes (rgb24, 1/d with the same operations as before, the box) its
//      own pair slot, so the copy needs no barrier of its own.  The gids
//      come from one coalesced read two chunks ahead, held in a register.
//      The decoded chunk is four float4 per pair, read with broadcast loads
//      instead of eleven scalar ones.  TMA does not fit: the rows are
//      gathered by gid, one 32- or 48-byte row each, not a tiled box.
//   3. Surface pass: the gids and depths of the first SURF_CAP (2,048)
//      entered pairs stay in shared memory (16 KB), so with surface_compact
//      most tiles read no global memory; its per-pair min is one
//      __reduce_min_sync, and warps without a valid pixel skip it.
//   4. Grid: block i blends tile tile_order[i], the wrapper's longest-run-
//      first order, so the long tiles start first and do not set the tail.
//      MIN_BLOCKS = 5 resident blocks per SM (registers capped at 48).
//   5. One C call launches an init kernel (keys 0, surface distances
//      FLT_MAX), the blend, and a finish kernel that decodes the keys into
//      contrib and best_pix in place, instead of a dozen elementwise PyTorch
//      launches around it.
// Measured and left out (PERF.md): persistent blocks pulling tiles from an
// atomic counter, two pixels per thread (128-thread blocks), a 4,096-pair
// surface store (32 KB, fewer resident blocks), 6 resident blocks (spills).
// Tensor cores are not used: the per-(pixel, pair) power is a rank-6
// quadratic form that a K=6 product could compute, but wgmma takes TF32 or
// bf16, which would part the kernel from its twin by more than a stop
// decision can absorb (the precision trap of DESIGN §7b).
#include <float.h>
#include <math.h>

#include "common.cuh"

#define FULL_MASK 0xffffffffu
#define FLT_MAX_BITS 0x7f7fffffu

#define NUM_WARPS (TILE_PIXELS / 32)
// Resident blocks per SM the register budget is set for.
#define MIN_BLOCKS 5
// Pairs of the entered chunks whose gid and depth stay in shared memory.
#define SURF_CAP 2048

struct BlendParams {
    const float* table;      // (P, table_lanes) per-Gaussian rows, original order
    const int* sorted_gid;   // (L,) Gaussian id per depth-sorted pair
    const int* starts;       // (num_tiles,) run start in the sorted pairs
    const int* counts;       // (num_tiles,) capped run length (0 = skip tile)
    const int* tile_order;   // (num_tiles,) the tile of each block
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
    int surf_cap;            // pairs whose gid and depth stay in shared memory
    float* image;            // (Hp * Wp, 3)
    float* depth;            // (Hp * Wp,)
    float* invdepth;
    float* trans;
    float* live;
    int* chunks;             // (num_tiles,) chunks the blend entered (r_fin)
    unsigned long long* key; // (P,) max key; best pixel after the finish kernel
    unsigned* surf_bits;     // (P,) float bits of the min surface distance
};

// Views of the dynamic shared memory (blend_smem_bytes gives its size).
struct Smem {
    unsigned long long* key;  // NUM_WARPS * Rs per-warp keys (surface pass: float bits)
    float4* row;              // 4 * Rs decoded rows [x y A B | C o d 1/d | r g b 0 | box]
    float* raw;               // Rs * raw_lanes raw table rows, cp.async target
    int* gid;                 // Rs gids of the chunk
    float* dep;               // Rs depths (surface pass, chunks not kept)
    int* store_gid;           // surf_cap gids of the entered chunks
    float* store_dep;         // surf_cap depths of the entered chunks
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    // The "memory" clobber keeps the slot's earlier shared loads (decode_row)
    // before the copy that overwrites it.
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int raw_lanes_of(int table_lanes) {
    // Compact rows: all 8 lanes; full rows: lanes 0-11 (rgb at 8-10).
    return table_lanes == 8 ? 8 : 12;
}

// Copy Gaussian g's raw row into the chunk's slot (owned by one thread).
__device__ __forceinline__ void stage_row(const BlendParams& p, const Smem& s, int g, int slot) {
    const int rl = raw_lanes_of(p.table_lanes);
    const float* src = p.table + (size_t)g * p.table_lanes;
    float* dst = s.raw + slot * rl;
    for (int q = 0; q < rl; q += 4) cp_async16(dst + q, src + q);
}

// The pixel box (x_min, x_max, y_min, y_max) outside which the Gaussian of
// a raw row blends nowhere: there o * exp(power) < 0.99 / 255 even before
// rounding, so the kernel's float alpha stays below 1/255 (the float error
// of power is orders of magnitude below the 1% margin, and the box has a
// pixel more on each side).  Empty when o < 1/255 (alpha <= o never
// reaches it), unbounded when the conic is not positive definite.
__device__ __forceinline__ float4 alpha_box(const float* row) {
    const float o = row[5];
    const float alpha_min = (float)(1.0 / 255.0);
    if (!(o >= alpha_min)) return make_float4(FLT_MAX, -FLT_MAX, FLT_MAX, -FLT_MAX);
    const double A = row[2], B = row[3], C = row[4];
    const double det = A * C - B * B;
    if (!(A > 0.0 && C > 0.0 && det > 0.0 && det < DBL_MAX))
        return make_float4(-FLT_MAX, FLT_MAX, -FLT_MAX, FLT_MAX);
    // power = -0.5 d^T Q d, Q = [[A, B], [B, C]], is >= ln(0.99 / (255 o))
    // only inside the ellipse d^T Q d <= r2, whose half-widths are
    // sqrt(r2 C / det) in x and sqrt(r2 A / det) in y.
    const double r2 = -2.0 * log(0.99 / (255.0 * (double)o));
    const double ex = sqrt(r2 * C / det) + 1.0, ey = sqrt(r2 * A / det) + 1.0;
    const double x = row[0], y = row[1];
    return make_float4((float)(x - ex), (float)(x + ex), (float)(y - ey), (float)(y + ey));
}

// Decode the staged row of a slot this thread owns (pair pair_idx of the run).
__device__ __forceinline__ void decode_row(const BlendParams& p, const Smem& s, int g, int j,
                                           int pair_idx) {
    const float* row = s.raw + j * raw_lanes_of(p.table_lanes);
    const float inv255 = (float)(1.0 / 255.0);
    const float d = row[6];
    s.row[4 * j] = make_float4(row[0], row[1], row[2], row[3]);
    s.row[4 * j + 1] = make_float4(row[4], row[5], d, 1.f / (fabsf(d) < 1e-12f ? 1e-12f : d));
    s.row[4 * j + 3] = alpha_box(row);
    if (p.table_lanes == 8) {
        const int v = (int)row[7];
        s.row[4 * j + 2] = make_float4((float)((v >> 16) & 255) * inv255,
                                       (float)((v >> 8) & 255) * inv255,
                                       (float)(v & 255) * inv255, 0.f);
    } else {
        s.row[4 * j + 2] = make_float4(row[8], row[9], row[10], 0.f);
    }
    s.gid[j] = g;
    if (pair_idx < p.surf_cap) {
        s.store_gid[pair_idx] = g;
        s.store_dep[pair_idx] = d;
    }
}

// One block of TILE_PIXELS threads blends one tile, a thread per pixel;
// thread t also owns slot t of each staged chunk.
__global__ void __launch_bounds__(TILE_PIXELS, MIN_BLOCKS)
    blend_tiles_kernel(const BlendParams p) {
    const int Rs = p.run_chunk;
    extern __shared__ float4 smem_f4[];
    __shared__ int s_wn[NUM_WARPS];
    Smem s;
    s.key = (unsigned long long*)smem_f4;
    s.row = (float4*)(s.key + NUM_WARPS * Rs);
    s.raw = (float*)(s.row + 4 * Rs);
    s.gid = (int*)(s.raw + Rs * raw_lanes_of(p.table_lanes));
    s.dep = (float*)(s.gid + Rs);
    s.store_gid = (int*)(s.dep + Rs);
    s.store_dep = (float*)(s.store_gid + p.surf_cap);

    const int tile = p.tile_order[blockIdx.x];
    const int tx = tile % p.grid_w, ty = tile / p.grid_w;
    const int lid = threadIdx.x;
    const int warp = lid >> 5, lane = lid & 31;
    const int gx = tx * TILE_EDGE + (lid % TILE_EDGE);
    const int gy = ty * TILE_EDGE + (lid / TILE_EDGE);
    const int pix = gy * p.width_pad + gx;
    // Padded pixel id of the warp's lane 0; lanes 0-15 and 16-31 are two rows.
    const int pix_warp = (ty * TILE_EDGE + 2 * warp) * p.width_pad + tx * TILE_EDGE;
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

    int r_fin = 0;
    bool all_done = __syncthreads_and(done);
    const bool any_valid = !all_done;
    int g_cur = 0, g_next = 0;
    if (!all_done && lid < min(Rs, count)) {
        g_cur = p.sorted_gid[start + lid];
        stage_row(p, s, g_cur, lid);
    }
    cp_async_commit();
    if (!all_done && lid < min(Rs, count - Rs)) g_next = p.sorted_gid[start + Rs + lid];
    for (int r = 0; r < n_chunks && !all_done; ++r) {
        r_fin = r + 1;
        const int n = min(Rs, count - r * Rs);
        cp_async_wait_all();
        if (lid < n) decode_row(p, s, g_cur, lid, r * Rs + lid);
        // Chunk r+1 copies into this thread's own slot while chunk r blends.
        if (lid < min(Rs, count - (r + 1) * Rs)) {
            g_cur = g_next;
            stage_row(p, s, g_cur, lid);
        }
        cp_async_commit();
        if (lid < min(Rs, count - (r + 2) * Rs)) g_next = p.sorted_gid[start + (r + 2) * Rs + lid];
        __syncthreads();

        int wn = 0;
        if (!__all_sync(FULL_MASK, done)) {
            // The warp's pixels: columns tx*16 .. +15 of rows wy0 .. wy0 + 1.
            const float wx0 = (float)(tx * TILE_EDGE), wx1 = wx0 + (float)(TILE_EDGE - 1);
            const float wy0 = (float)(ty * TILE_EDGE + 2 * warp), wy1 = wy0 + 1.f;
            for (int j = 0; j < n; ++j) {
                unsigned long long key = 0ull;
                wn = j + 1;
                const float4 bx = s.row[4 * j + 3];
                // Warp-uniform: a Gaussian whose alpha box misses the warp's
                // pixels blends none of them (w = 0 on every lane).
                if (bx.y < wx0 || bx.x > wx1 || bx.w < wy0 || bx.z > wy1) {
                    if (lane == 0) s.key[warp * Rs + j] = key;
                    continue;
                }
                float w = 0.f;
                if (!done) {
                    const float4 ga = s.row[4 * j], gb = s.row[4 * j + 1];
                    const float dx = pxf - ga.x;
                    const float dy = pyf - ga.y;
                    const float power = __fsub_rn(
                        __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(ga.z, dx), dx),
                                                   __fmul_rn(__fmul_rn(gb.x, dy), dy))),
                        __fmul_rn(__fmul_rn(ga.w, dx), dy));
                    if (power <= 0.f) {
                        const float alpha = fminf(0.99f, __fmul_rn(gb.y, expf(power)));
                        if (alpha >= alpha_min) {
                            const float test_T = __fmul_rn(T, 1.f - alpha);
                            if (p.early_stop && test_T < 1e-4f) {
                                done = true;
                            } else {
                                const float4 gc = s.row[4 * j + 2];
                                w = __fmul_rn(alpha, T);
                                cr = __fadd_rn(cr, __fmul_rn(w, gc.x));
                                cg = __fadd_rn(cg, __fmul_rn(w, gc.y));
                                cb = __fadd_rn(cb, __fmul_rn(w, gc.z));
                                ed = __fadd_rn(ed, __fmul_rn(w, gb.z));
                                einv = __fadd_rn(einv, __fmul_rn(w, gb.w));
                                T = test_T;
                            }
                        }
                    }
                }
                // The warp's max w and its lowest pixel (lanes are in pixel order).
                const unsigned bits = __float_as_uint(w);
                const unsigned m = __reduce_max_sync(FULL_MASK, bits);
                if (m != 0u) {
                    const int l = __ffs(__ballot_sync(FULL_MASK, bits == m)) - 1;
                    const unsigned apix = (unsigned)(pix_warp + (l >> 4) * p.width_pad + (l & 15));
                    key = ((unsigned long long)m << 32) | (unsigned long long)(0xFFFFFFFFu - apix);
                }
                if (lane == 0) s.key[warp * Rs + j] = key;
                if (__all_sync(FULL_MASK, done)) break;
            }
        }
        if (lane == 0) s_wn[warp] = wn;
        __syncthreads();

        for (int j = lid; j < n; j += TILE_PIXELS) {
            unsigned long long k = 0ull;
            for (int wi = 0; wi < NUM_WARPS; ++wi) {
                if (j < s_wn[wi]) {
                    const unsigned long long o = s.key[wi * Rs + j];
                    k = o > k ? o : k;
                }
            }
            if (k != 0ull) atomicMax(&p.key[s.gid[j]], k);
        }
        // Also the barrier that frees the decoded chunk for the next one.
        all_done = __syncthreads_and(done);
    }
    // A copy issued for a chunk the tile never entered lands before exit.
    cp_async_wait_all();

    const float tbg = __fmul_rn(T, p.bg);
    p.image[3 * pix + 0] = valid ? __fadd_rn(cr, tbg) : 0.f;
    p.image[3 * pix + 1] = valid ? __fadd_rn(cg, tbg) : 0.f;
    p.image[3 * pix + 2] = valid ? __fadd_rn(cb, tbg) : 0.f;
    p.depth[pix] = valid ? ed : 0.f;
    p.invdepth[pix] = valid ? einv : 0.f;
    p.trans[pix] = valid ? T : 1.f;
    p.live[pix] = (valid && !done) ? T : 0.f;
    if (lid == 0) p.chunks[tile] = r_fin;

    // A tile without a valid pixel has no surface distance to give.
    if (!p.with_surface || !any_valid) return;
    // Surface pass: min over valid pixels of |pair depth - expected depth|,
    // over the chunks the blend entered (surface_compact) or the whole run.
    const int n_surf = p.surface_compact ? r_fin : n_chunks;
    const int n_kept = min(min(r_fin * Rs, count), p.surf_cap);
    const float ed_target = p.ed_override != nullptr ? p.ed_override[pix] : ed;
    const bool warp_valid = __any_sync(FULL_MASK, valid);
    unsigned* s_sd = (unsigned*)s.key;
    if (lane == 0) s_wn[warp] = warp_valid;
    for (int r = 0; r < n_surf; ++r) {
        const int base = r * Rs;
        const int n = min(Rs, count - base);
        const int* cgid = s.store_gid + base;
        const float* cdep = s.store_dep + base;
        if (base + n > n_kept) {
            for (int j = lid; j < n; j += TILE_PIXELS) {
                const int g = p.sorted_gid[start + base + j];
                s.gid[j] = g;
                s.dep[j] = p.table[(size_t)g * p.table_lanes + 6];
            }
            __syncthreads();
            cgid = s.gid;
            cdep = s.dep;
        }
        if (warp_valid) {
            for (int j = 0; j < n; ++j) {
                const float dist = valid ? fabsf(cdep[j] - ed_target) : FLT_MAX;
                const unsigned m = __reduce_min_sync(FULL_MASK, __float_as_uint(dist));
                if (lane == 0) s_sd[warp * Rs + j] = m;
            }
        }
        __syncthreads();
        for (int j = lid; j < n; j += TILE_PIXELS) {
            unsigned v = FLT_MAX_BITS;
            for (int wi = 0; wi < NUM_WARPS; ++wi)
                if (s_wn[wi]) v = min(v, s_sd[wi * Rs + j]);
            if (v < FLT_MAX_BITS) atomicMin(&p.surf_bits[cgid[j]], v);
        }
        __syncthreads();
    }
}

__global__ void blend_init_kernel(unsigned long long* key, unsigned* surf_bits, int P) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < P) {
        key[i] = 0ull;
        surf_bits[i] = FLT_MAX_BITS;
    }
}

// key -> contrib (its high word as a float) and, in place, the best pixel.
__global__ void blend_finish_kernel(unsigned long long* key, float* contrib, int P) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= P) return;
    const unsigned long long k = key[i];
    contrib[i] = k != 0ull ? __uint_as_float((unsigned)(k >> 32)) : 0.f;
    key[i] = k != 0ull ? 0xFFFFFFFFull - (k & 0xFFFFFFFFull) : 0ull;
}

static size_t blend_smem_bytes(int run_chunk, int table_lanes, int surf_cap) {
    const size_t raw = table_lanes == 8 ? 8 : 12;
    return (size_t)run_chunk * (NUM_WARPS * sizeof(unsigned long long) + 4 * sizeof(float4) +
                                raw * sizeof(float) + 2 * sizeof(int)) +
           (size_t)surf_cap * 2 * sizeof(int);
}

GS2PC_API int gs2pc_blend_tiles(const void* table, const void* sorted_gid, const void* starts,
                                const void* counts, const void* tile_order, const void* mask,
                                const void* init_trans, const void* ed_override, int early_stop,
                                int table_lanes, int num_tiles, int width, int height,
                                int grid_w, int width_pad, int run_chunk, float bg,
                                int with_surface, int surface_compact, void* image, void* depth,
                                void* invdepth, void* trans, void* live, void* chunks,
                                void* contrib, void* best_pix, void* surf_dist, int P,
                                void* stream) {
    BlendParams prm;
    prm.table = (const float*)table;
    prm.sorted_gid = (const int*)sorted_gid;
    prm.starts = (const int*)starts;
    prm.counts = (const int*)counts;
    prm.tile_order = (const int*)tile_order;
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
    prm.surf_cap = with_surface ? SURF_CAP : 0;
    prm.image = (float*)image;
    prm.depth = (float*)depth;
    prm.invdepth = (float*)invdepth;
    prm.trans = (float*)trans;
    prm.live = (float*)live;
    prm.chunks = (int*)chunks;
    prm.key = (unsigned long long*)best_pix;
    prm.surf_bits = (unsigned*)surf_dist;
    const cudaStream_t st = (cudaStream_t)stream;
    const size_t smem = blend_smem_bytes(run_chunk, table_lanes, prm.surf_cap);
    const cudaError_t e = cudaFuncSetAttribute(
        blend_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (P > 0) blend_init_kernel<<<(P + 255) / 256, 256, 0, st>>>(prm.key, prm.surf_bits, P);
    if (num_tiles > 0) blend_tiles_kernel<<<num_tiles, TILE_PIXELS, smem, st>>>(prm);
    if (P > 0) blend_finish_kernel<<<(P + 255) / 256, 256, 0, st>>>(prm.key, (float*)contrib, P);
    return (int)cudaGetLastError();
}
