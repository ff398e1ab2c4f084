// K5 -- the fused point sampler.
//
// Replaces: gs2pc/ops/sampler.py::sample_points (:149-247), an XLA stage of
// the JAX package (not Pallas): the scatter-max + cummax slot -> Gaussian
// map, jax.random's threefry draws (split(key), normal(kz, (n_cap, 3)),
// uniform(ku, (n_cap,))), the truncated-chi_3 radius by 26 bisection
// rounds, and x = mu + R (exp(s) * z) with each Gaussian's first slot its
// exact centre.
//
// Every value of slot s of the global slot range depends on s alone, so any
// split of the range into blocks [lo, lo + count) (one per rank of an SPMD
// conversion) computes the same bits as the whole:
//   * the owner g = the first Gaussian whose inclusive quota prefix exceeds
//     s (a zero-quota Gaussian never owns a slot, as the JAX map's max picks
//     the real owner), and s is a centre when it equals g's exclusive
//     prefix;
//   * the draws are JAX's, keyed on the global counter: normals at flat
//     indices 3s + c under kz, the uniform at s under ku, each word the xor
//     of threefry2x32's two outputs for the counter (hi, lo) -- computed
//     here, never stored;
//   * normals by XLA's float32 erf_inv polynomial (gs2pc_torch/ops/prng.py).
//
// Bit-equality with the twin (gs2pc_torch/ops/sampler.py::
// sample_points_torch) run on the card: every float operation is the
// twin's, in its order, with round-to-nearest intrinsics (no FMA
// contraction), and the libm calls are the ones PyTorch's CUDA kernels make
// (erff, expf, log1pf, sqrtf, all accurate; IEEE division).
//
// What bounds it on an H100: instruction issue.  A drawn point costs four
// threefry blocks (~75 integer operations each), three erf_inv, and 26
// bisection rounds of erff + expf, none of them fused (~1,500 SASS
// instructions, ~40% on the ALU pipe); it moves 48 bytes a Gaussian in and
// 20 a point out.  The design issues less of that work:
//   * persistent CTAs, one wave (the occupancy API: 6 a SM at <= 40
//     registers and ~37 KB of shared memory), walk tiles of K5_TILE slots
//     with a grid stride;
//   * each CTA builds once, in shared memory, chi3_cdf(mid) of every node of
//     the bisection tree's first K5_TABLE_LEVELS levels (the bracket starts
//     at [0, min(std, 16)] for every point, so those thresholds are shared)
//     and chi3_cdf(std); a point walks the table with one compare a level,
//     rlo / rhi updated as the bisection does, then runs the remaining
//     rounds -- every decision compares the same two floats;
//   * owners per tile: the tile's first owner by a 32-way warp search of the
//     prefix (~5 rounds; a CTA's first K5_FIRST tiles' searches all at its
//     start, a warp each), the prefix run after it in shared memory as int32
//     offsets from the tile's first slot, and each slot's owner by a halving
//     search there, a thread's four interleaved (a run of zero quotas past
//     the window searches the whole prefix); the rows of the tile's owners
//     (mean, rotation, expf of the log scales) are staged once, coalesced;
//   * a centre draws nothing: its point, x + R (exp(s) * 0), is written from
//     the staged row; the other slots of the tile are compacted (ballot /
//     popc, in slot order) so that whole warps draw.
// chip_smoke.k5_bound counts what a call's quotas need; PERF.md gives the
// times of the design steps kept and dropped.
#include <climits>

#include "common.cuh"

#define K5_THREADS 256
#define K5_TILE 1024
#define K5_SLOTS (K5_TILE / K5_THREADS)  // slots a thread owns in a tile
#define K5_WARPS (K5_THREADS / 32)
#define K5_WINDOW K5_TILE                // prefix entries after the tile's first owner
#define K5_BISECT 26
#define K5_TABLE_LEVELS 12
#define K5_TABLE_NODES (1 << K5_TABLE_LEVELS)  // heap nodes 1 .. 2^L - 1
#define K5_ROWS 256                      // a tile's owners staged in shared memory
#define K5_FIRST 64                      // tiles a CTA finds the first owners of up front
#define K5_MIN_CTAS 6                    // resident CTAs an SM must hold (registers)

static_assert(K5_SLOTS * K5_WARPS == 32, "one warp scans the tile's per-warp counts");
static_assert(K5_TABLE_LEVELS <= K5_BISECT, "the table covers at most every round");
static_assert((K5_WINDOW & (K5_WINDOW - 1)) == 0, "the owner search halves the window");

namespace {

constexpr unsigned KS_PARITY = 0x1BD11BDAu;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;
constexpr float INV_SQRT_2 = 0.7071067811865476f;
constexpr float NORMAL_LO = -0.99999994f;  // nextafter(-1, 0)
constexpr float SQRT2 = 1.4142135623730951f;

__device__ __forceinline__ unsigned rotl(unsigned x, int r) { return __funnelshift_l(x, x, r); }

// threefry2x32 (20 rounds) of the counter (x0, x1) = (hi, lo); the xor of
// its two output words.
__device__ __forceinline__ unsigned threefry_word(unsigned k0, unsigned k1, unsigned long long i) {
    const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ KS_PARITY};
    unsigned x0 = (unsigned)(i >> 32) + ks[0];
    unsigned x1 = (unsigned)(i & 0xFFFFFFFFull) + ks[1];
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
    for (int g = 0; g < 5; ++g) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            x0 += x1;
            x1 = rotl(x1, rot[g & 1][k]) ^ x0;
        }
        x0 += ks[(g + 1) % 3];
        x1 += ks[(g + 2) % 3] + (unsigned)(g + 1);
    }
    return x0 ^ x1;
}

// jax.random.uniform's float: the top 23 bits as [1, 2), minus 1, then
// * (hi - lo) + lo, at least lo.
__device__ __forceinline__ float uniform_of(unsigned bits, float lo, float hi) {
    const float f = __fsub_rn(__int_as_float((int)((bits >> 9) | 0x3F800000u)), 1.0f);
    return fmaxf(lo, __fadd_rn(__fmul_rn(f, __fsub_rn(hi, lo)), lo));
}

// XLA's ErfInv32, operation by operation.
__device__ __forceinline__ float erfinv_xla(float x) {
    const float lt5[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                          -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                          -0.00417768164f, 0.246640727f, 1.50140941f};
    const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                          -0.00367342844f, 0.00573950773f, -0.0076224613f,
                          0.00943887047f, 1.00167406f, 2.83297682f};
    const float w0 = -log1pf(-__fmul_rn(x, x));
    const bool lt = w0 < 5.0f;
    const float w = lt ? __fsub_rn(w0, 2.5f) : __fsub_rn(sqrtf(w0), 3.0f);
    float p = lt ? lt5[0] : ge5[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = __fadd_rn(lt ? lt5[i] : ge5[i], __fmul_rn(p, w));
    return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000)) : __fmul_rn(p, x);
}

__device__ __forceinline__ float normal_at(unsigned k0, unsigned k1, unsigned long long i) {
    return __fmul_rn(SQRT2, erfinv_xla(uniform_of(threefry_word(k0, k1, i), NORMAL_LO, 1.0f)));
}

// CDF of chi_3: erf(r / sqrt 2) - sqrt(2 / pi) r exp(-r^2 / 2), in the
// twin's order.
__device__ __forceinline__ float chi3_cdf(float r) {
    const float e = expf(__fmul_rn(__fmul_rn(-0.5f, r), r));
    return __fsub_rn(erff(__fmul_rn(r, INV_SQRT_2)), __fmul_rn(__fmul_rn(SQRT_2_OVER_PI, r), e));
}

// The bisection's midpoint of [rlo, rhi], as the twin takes it.
__device__ __forceinline__ float midpoint(float rlo, float rhi) {
    return __fmul_rn(0.5f, __fadd_rn(rlo, rhi));
}

__device__ __forceinline__ void cross(float ax, float ay, float az, float bx, float by, float bz,
                                      float& cx, float& cy, float& cz) {
    cx = __fsub_rn(__fmul_rn(ay, bz), __fmul_rn(az, by));
    cy = __fsub_rn(__fmul_rn(az, bx), __fmul_rn(ax, bz));
    cz = __fsub_rn(__fmul_rn(ax, by), __fmul_rn(ay, bx));
}

// A Gaussian's mean, rotation (w, x, y, z) and exp(log_scales).
struct Row {
    float x, y, z, qw, qx, qy, qz, e0, e1, e2;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ xyz,
                                        const float* __restrict__ log_scales,
                                        const float* __restrict__ rots, long long g) {
    Row r;
    r.x = xyz[3 * g];
    r.y = xyz[3 * g + 1];
    r.z = xyz[3 * g + 2];
    r.qw = rots[4 * g];
    r.qx = rots[4 * g + 1];
    r.qy = rots[4 * g + 2];
    r.qz = rots[4 * g + 3];
    r.e0 = expf(log_scales[3 * g]);
    r.e1 = expf(log_scales[3 * g + 1]);
    r.e2 = expf(log_scales[3 * g + 2]);
    return r;
}

// Point j = mean + rotate(q, e * v): v + w t + u x t with t = 2 (u x v), as
// ops/quaternion.quat_rotate.
__device__ __forceinline__ void emit_point(const Row& g, float vx, float vy, float vz,
                                           float* __restrict__ points, long long j) {
    vx = __fmul_rn(g.e0, vx);
    vy = __fmul_rn(g.e1, vy);
    vz = __fmul_rn(g.e2, vz);
    float tx, ty, tz, ex, ey, ez;
    cross(g.qx, g.qy, g.qz, vx, vy, vz, tx, ty, tz);
    tx = __fmul_rn(2.0f, tx);
    ty = __fmul_rn(2.0f, ty);
    tz = __fmul_rn(2.0f, tz);
    cross(g.qx, g.qy, g.qz, tx, ty, tz, ex, ey, ez);
    points[3 * j] = __fadd_rn(g.x, __fadd_rn(__fadd_rn(vx, __fmul_rn(g.qw, tx)), ex));
    points[3 * j + 1] = __fadd_rn(g.y, __fadd_rn(__fadd_rn(vy, __fmul_rn(g.qw, ty)), ey));
    points[3 * j + 2] = __fadd_rn(g.z, __fadd_rn(__fadd_rn(vz, __fmul_rn(g.qw, tz)), ez));
}

// The owner of slot s (the upper bound of s in prefix[0, P), which exists:
// s < prefix[P - 1]) by a 32-way search over the whole warp: each round the
// lanes probe 32 points of the bracket and keep the piece between the last
// at or below s and the first above it (~5 rounds for 3M Gaussians).
__device__ __forceinline__ long long first_owner(const int64_t* __restrict__ prefix, int P,
                                                 long long s, int lane) {
    long long a = 0, b = (long long)P - 1;  // the owner lies in [a, b]
    while (a < b) {
        const long long idx = a + (((b - a) * (lane + 1)) >> 5);  // lane 31 probes b
        const bool above = lane == 31 || prefix[idx] > s;
        const int f = __ffs(__ballot_sync(FULL, above)) - 1;
        const long long at = __shfl_sync(FULL, idx, f);
        const long long before = __shfl_sync(FULL, idx, f > 0 ? f - 1 : 0);
        b = at;
        if (f > 0) a = before + 1;
    }
    return a;
}

// One call's inputs and outputs.
struct K5Args {
    const int64_t* __restrict__ prefix;
    int P;
    const float* __restrict__ xyz;
    const float* __restrict__ log_scales;
    const float* __restrict__ rots;
    long long lo, count;
    unsigned kz0, kz1, ku0, ku1;
    float std_dev;
    float* __restrict__ points;
    int64_t* __restrict__ gid;
};

struct K5Shared {
    float cdf[K5_TABLE_NODES];      // chi3_cdf(mid) of the table's nodes (entry 0 unused)
    long long first[K5_FIRST];      // owner of the first slot of the CTA's tiles 0, 1, ...
    int rel[K5_WINDOW + 1];         // exclusive prefix of Gaussian g0 + i, less s0 (clamped)
    float row[10][K5_ROWS];         // Row of Gaussian g0 + i, field by field
    int owner[K5_TILE];             // owner of each slot of the tile
    unsigned short list[K5_TILE];   // the tile's slots that draw, in slot order
    int counts[K5_SLOTS * K5_WARPS];  // slots that draw, per (round, warp)
    int rows;                       // rows staged: the tile's owners from g0, at most K5_ROWS
};

// Gaussian g's row: staged in shared memory when g - g0 < rows.
__device__ __forceinline__ Row row_of(const K5Shared& sm, int rows, long long g0, long long g,
                                      const K5Args& in) {
    const long long i = g - g0;
    if (i >= rows) return load_row(in.xyz, in.log_scales, in.rots, g);
    return Row{sm.row[0][i], sm.row[1][i], sm.row[2][i], sm.row[3][i], sm.row[4][i],
               sm.row[5][i], sm.row[6][i], sm.row[7][i], sm.row[8][i], sm.row[9][i]};
}

// Draws, radius and point of slot k of the tile, not a centre.
__device__ __forceinline__ void draw_slot(const K5Shared& sm, int rows, int k, long long s0,
                                          long long j0, long long g0, const K5Args& in,
                                          float hi0, float cdf_std) {
    const unsigned long long s = (unsigned long long)(s0 + k);
    const float zx = normal_at(in.kz0, in.kz1, 3ull * s);
    const float zy = normal_at(in.kz0, in.kz1, 3ull * s + 1);
    const float zz = normal_at(in.kz0, in.kz1, 3ull * s + 2);
    const float t = __fmul_rn(uniform_of(threefry_word(in.ku0, in.ku1, s), 0.0f, 1.0f), cdf_std);

    // Truncated chi_3 radius: the table's levels, then the rest of the
    // bisection rounds.
    float rlo = 0.0f, rhi = hi0;
    int node = 1;
#pragma unroll
    for (int it = 0; it < K5_TABLE_LEVELS; ++it) {
        const float mid = midpoint(rlo, rhi);
        const bool below = sm.cdf[node] < t;
        if (below) rlo = mid; else rhi = mid;
        node = 2 * node + (int)below;
    }
    for (int it = K5_TABLE_LEVELS; it < K5_BISECT; ++it) {
        const float mid = midpoint(rlo, rhi);
        if (chi3_cdf(mid) < t) rlo = mid; else rhi = mid;
    }
    const float r = midpoint(rlo, rhi);

    const float norm = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(zx, zx), __fmul_rn(zy, zy)),
                                       __fmul_rn(zz, zz)));
    const float ratio = __fdiv_rn(r, fmaxf(norm, 1e-12f));
    emit_point(row_of(sm, rows, g0, sm.owner[k], in), __fmul_rn(zx, ratio),
               __fmul_rn(zy, ratio), __fmul_rn(zz, ratio), in.points, j0 + k);
}

__global__ void __launch_bounds__(K5_THREADS, K5_MIN_CTAS) sample_points_kernel(const K5Args in) {
    extern __shared__ __align__(16) unsigned char k5_smem[];
    K5Shared& sm = *reinterpret_cast<K5Shared*>(k5_smem);
    const int64_t* __restrict__ prefix = in.prefix;
    const int P = in.P;
    const long long lo = in.lo, count = in.count;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float hi0 = fminf(in.std_dev, 16.0f);

    // The threshold table: node n of depth d (n in [2^d, 2^(d+1))) is reached
    // by the decisions in n's bits below its leading one, 1 = "below" (rlo =
    // mid), as the bisection takes them from [0, hi0].
    for (int node = 1 + tid; node < K5_TABLE_NODES; node += K5_THREADS) {
        float rlo = 0.0f, rhi = hi0;
        for (int d = 30 - __clz(node); d >= 0; --d) {
            const float mid = midpoint(rlo, rhi);
            if ((node >> d) & 1) rlo = mid; else rhi = mid;
        }
        sm.cdf[node] = chi3_cdf(midpoint(rlo, rhi));
    }
    const float cdf_std = chi3_cdf(in.std_dev);
    const unsigned lanes_below = (1u << lane) - 1u;

    // The first owners of the CTA's first K5_FIRST tiles, a warp a tile, so
    // that their searches' latencies overlap (later tiles search in turn).
    const long long tiles = (count + K5_TILE - 1) / K5_TILE;
    for (int i = warp; i < K5_FIRST; i += K5_WARPS) {
        const long long tile = blockIdx.x + (long long)i * gridDim.x;
        if (tile < tiles) {
            const long long g = first_owner(prefix, P, lo + tile * K5_TILE, lane);
            if (lane == 0) sm.first[i] = g;
        }
    }
    __syncthreads();

    for (long long tile = blockIdx.x, i = 0; tile < tiles; tile += gridDim.x, ++i) {
        const long long j0 = tile * K5_TILE;
        const int len = (int)min((long long)K5_TILE, count - j0);
        const long long s0 = lo + j0;
        const long long g0 = i < K5_FIRST ? sm.first[i] : first_owner(prefix, P, s0, lane);
        for (int w = tid; w <= K5_WINDOW; w += K5_THREADS) {
            const long long g = g0 + w - 1;
            const long long e = g < 0 ? 0 : (g < P ? (long long)prefix[g] : LLONG_MAX);
            sm.rel[w] = (int)max(-1ll, min(e - s0, (long long)INT_MAX));
        }
        __syncthreads();

        // Owners: the last window entry at or below each slot (rel[0] <= 0
        // <= k), the thread's K5_SLOTS searches interleaved; a slot past the
        // window (a run of zero quotas) searches the whole prefix.
        int pos[K5_SLOTS];
#pragma unroll
        for (int r = 0; r < K5_SLOTS; ++r) pos[r] = 0;
#pragma unroll
        for (int step = K5_WINDOW / 2; step >= 1; step >>= 1) {
#pragma unroll
            for (int r = 0; r < K5_SLOTS; ++r)
                if (sm.rel[pos[r] + step] <= tid + r * K5_THREADS) pos[r] += step;
        }
        unsigned draws[K5_SLOTS];
        unsigned centres = 0;  // bit r: slot tid + 256 r is a centre
#pragma unroll
        for (int r = 0; r < K5_SLOTS; ++r) {
            const int k = tid + r * K5_THREADS;
            bool draw = false;
            if (k < len) {
                long long g;
                bool centre;
                if (sm.rel[K5_WINDOW] > k) {
                    g = g0 + pos[r];
                    centre = sm.rel[pos[r]] == k;
                } else {
                    const long long s = s0 + k;
                    long long a = g0 + K5_WINDOW, b = (long long)P - 1;
                    while (a < b) {
                        const long long m = (a + b) >> 1;
                        if (prefix[m] > s) b = m; else a = m + 1;
                    }
                    g = a;
                    centre = s == prefix[a - 1];
                }
                sm.owner[k] = (int)g;
                in.gid[j0 + k] = g;
                if (k == len - 1) sm.rows = (int)min(g - g0 + 1, (long long)K5_ROWS);
                draw = !centre;
                centres |= (unsigned)centre << r;
            }
            draws[r] = __ballot_sync(FULL, draw);
            if (lane == 0) sm.counts[r * K5_WARPS + warp] = __popc(draws[r]);
        }
        __syncthreads();

        // Stage the rows of the tile's owners (coalesced), and compact the
        // drawing slots in slot order (k = 256 r + 32 warp + lane): an
        // inclusive scan of the 32 (round, warp) counts over the lanes.
        const int rows = sm.rows;
        for (int w = tid; w < rows; w += K5_THREADS) {
            const Row g = load_row(in.xyz, in.log_scales, in.rots, g0 + w);
            sm.row[0][w] = g.x;
            sm.row[1][w] = g.y;
            sm.row[2][w] = g.z;
            sm.row[3][w] = g.qw;
            sm.row[4][w] = g.qx;
            sm.row[5][w] = g.qy;
            sm.row[6][w] = g.qz;
            sm.row[7][w] = g.e0;
            sm.row[8][w] = g.e1;
            sm.row[9][w] = g.e2;
        }
        const int c = sm.counts[lane];
        int incl = c;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(FULL, incl, d);
            if (lane >= d) incl += v;
        }
        const int m = __shfl_sync(FULL, incl, 31);
#pragma unroll
        for (int r = 0; r < K5_SLOTS; ++r) {
            const int base = __shfl_sync(FULL, incl - c, r * K5_WARPS + warp);
            if ((draws[r] >> lane) & 1u)
                sm.list[base + __popc(draws[r] & lanes_below)] =
                    (unsigned short)(tid + r * K5_THREADS);
        }
        __syncthreads();

        // Every slot that is not a centre draws; then the centres, x + R
        // (exp(s) * 0) with the same operations.
        for (int idx = tid; idx < m; idx += K5_THREADS)
            draw_slot(sm, rows, sm.list[idx], s0, j0, g0, in, hi0, cdf_std);
#pragma unroll
        for (int r = 0; r < K5_SLOTS; ++r) {
            const int k = tid + r * K5_THREADS;
            if ((centres >> r) & 1u)
                emit_point(row_of(sm, rows, g0, sm.owner[k], in), 0.0f, 0.0f, 0.0f, in.points,
                           j0 + k);
        }
    }
}

// The grid of a call over ``count`` slots: the CTAs the card holds at once
// (occupancy per SM x SMs), at most one per tile.
int sample_grid(long long count) {
    static int resident[64] = {0};  // per device; 0 = not asked yet
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) dev = 0;
    if (resident[dev] == 0) {
        int per_sm = 0, sms = 0;
        cudaFuncSetAttribute(sample_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(K5Shared));
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sample_points_kernel, K5_THREADS,
                                                      sizeof(K5Shared));
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        resident[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
    }
    const long long tiles = (count + K5_TILE - 1) / K5_TILE;
    return (int)(tiles < resident[dev] ? tiles : resident[dev]);
}

}  // namespace

// Slots [lo, lo + count) of the sampler: points (count, 3) f32 and the
// owning Gaussian (count,) int64.  prefix is the inclusive int64 prefix sum
// of the P quotas; (kz0, kz1), (ku0, ku1) the two halves of split(key).
GS2PC_API int gs2pc_sample_points(const int64_t* prefix, int P, const float* xyz,
                                  const float* log_scales, const float* rots, long long lo,
                                  long long count, unsigned kz0, unsigned kz1, unsigned ku0,
                                  unsigned ku1, float std_dev, float* points, int64_t* gid,
                                  cudaStream_t stream) {
    if (count <= 0) return 0;
    const K5Args in{prefix, P, xyz, log_scales, rots, lo, count, kz0, kz1, ku0, ku1,
                    std_dev, points, gid};
    sample_points_kernel<<<sample_grid(count), K5_THREADS, sizeof(K5Shared), stream>>>(in);
    return (int)cudaGetLastError();
}

// The CTAs a call over ``count`` slots launches on the current device, and
// the table's levels and the tile's slots (chip_smoke.k5_bound counts the
// table once a CTA).
GS2PC_API int gs2pc_sample_points_layout(long long count, int* grid, int* table_levels,
                                         int* tile) {
    *grid = count > 0 ? sample_grid(count) : 0;
    *table_levels = K5_TABLE_LEVELS;
    *tile = K5_TILE;
    return (int)cudaGetLastError();
}
