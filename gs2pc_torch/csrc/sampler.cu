// K5 -- the fused point sampler.
//
// Replaces: gs2pc/ops/sampler.py::sample_points (:149-247), an XLA stage of
// the JAX package (not Pallas): the scatter-max + cummax slot -> Gaussian
// map, jax.random's threefry draws (split(key), normal(kz, (n_cap, 3)),
// uniform(ku, (n_cap,))), the truncated-chi_3 radius by 26 bisection
// rounds, and x = mu + R (exp(s) * z) with each Gaussian's first slot its
// exact centre.
//
// One thread per slot s of a block [lo, lo + count) of the global slot
// range, so any split of the range into blocks (one per rank of an SPMD
// conversion) computes the same bits as the whole:
//   * the owner g = the first Gaussian whose inclusive quota prefix exceeds
//     s (binary search; a zero-quota Gaussian never owns a slot, as the
//     JAX map's max picks the real owner), and s is a centre when it equals
//     g's exclusive prefix;
//   * the draws are JAX's, keyed on the global counter: normals at flat
//     indices 3s + c under kz, the uniform at s under ku, each word the xor
//     of threefry2x32's two outputs for the counter (hi, lo) -- computed
//     here, never stored (the PyTorch twin puts 16 bytes a slot of draws in
//     memory);
//   * normals by XLA's float32 erf_inv polynomial (gs2pc_torch/ops/prng.py).
//
// Bit-equality with the twin (gs2pc_torch/ops/sampler.py::
// sample_points_torch) run on the card: every float operation is the
// twin's, in its order, with round-to-nearest intrinsics (no FMA
// contraction), and the libm calls are the ones PyTorch's CUDA kernels make
// (erff, expf, log1pf, sqrtf, all accurate; IEEE division).
//
// What bounds it on an H100: operations.  A point costs four threefry
// blocks (~80 integer operations each), three erf_inv (log1pf, sqrtf and a
// degree-8 Horner), the 26 bisection rounds of erff + expf and the owner
// search (~22 probes of a prefix that stays in L2); it moves 48 bytes a
// Gaussian in and 20 a point out.  chip_smoke.k5_bound counts both; a
// simple kernel, one thread a slot and 256 a block, is this slice's design.
#include "common.cuh"

#define K5_THREADS 256
#define K5_BISECT 26

namespace {

constexpr unsigned KS_PARITY = 0x1BD11BDAu;
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

__device__ __forceinline__ void cross(float ax, float ay, float az, float bx, float by, float bz,
                                      float& cx, float& cy, float& cz) {
    cx = __fsub_rn(__fmul_rn(ay, bz), __fmul_rn(az, by));
    cy = __fsub_rn(__fmul_rn(az, bx), __fmul_rn(ax, bz));
    cz = __fsub_rn(__fmul_rn(ax, by), __fmul_rn(ay, bx));
}

__global__ void __launch_bounds__(K5_THREADS)
sample_points_kernel(const int64_t* __restrict__ prefix, int P, const float* __restrict__ xyz,
                     const float* __restrict__ log_scales, const float* __restrict__ rots,
                     long long lo, long long count, unsigned kz0, unsigned kz1, unsigned ku0,
                     unsigned ku1, float std_dev, float* __restrict__ points,
                     int64_t* __restrict__ gid_out) {
    const long long j = (long long)blockIdx.x * K5_THREADS + threadIdx.x;
    if (j >= count) return;
    const long long s = lo + j;

    // Owner: upper bound of s in the inclusive prefix.
    int a = 0, b = P;
    while (a < b) {
        const int m = (a + b) >> 1;
        if (prefix[m] > s) b = m; else a = m + 1;
    }
    const int g = a;
    const bool centre = s == (g > 0 ? prefix[g - 1] : 0);

    const unsigned long long c = 3ull * (unsigned long long)s;
    const float zx = normal_at(kz0, kz1, c);
    const float zy = normal_at(kz0, kz1, c + 1);
    const float zz = normal_at(kz0, kz1, c + 2);
    const float u = uniform_of(threefry_word(ku0, ku1, (unsigned long long)s), 0.0f, 1.0f);

    // Truncated chi_3 radius by bisection, the bracket capped at 16.
    const float t = __fmul_rn(u, chi3_cdf(std_dev));
    float rlo = 0.0f, rhi = fminf(std_dev, 16.0f);
    for (int it = 0; it < K5_BISECT; ++it) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(rlo, rhi));
        if (chi3_cdf(mid) < t) rlo = mid; else rhi = mid;
    }
    const float r = __fmul_rn(0.5f, __fadd_rn(rlo, rhi));

    const float norm = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(zx, zx), __fmul_rn(zy, zy)),
                                       __fmul_rn(zz, zz)));
    const float ratio = __fdiv_rn(r, fmaxf(norm, 1e-12f));
    float vx = 0.0f, vy = 0.0f, vz = 0.0f;
    if (!centre) {
        vx = __fmul_rn(zx, ratio);
        vy = __fmul_rn(zy, ratio);
        vz = __fmul_rn(zz, ratio);
    }
    vx = __fmul_rn(expf(log_scales[3 * g]), vx);
    vy = __fmul_rn(expf(log_scales[3 * g + 1]), vy);
    vz = __fmul_rn(expf(log_scales[3 * g + 2]), vz);

    // v + w t + u x t with t = 2 (u x v): ops/quaternion.quat_rotate.
    const float qw = rots[4 * g], qx = rots[4 * g + 1], qy = rots[4 * g + 2],
                qz = rots[4 * g + 3];
    float tx, ty, tz, ex, ey, ez;
    cross(qx, qy, qz, vx, vy, vz, tx, ty, tz);
    tx = __fmul_rn(2.0f, tx);
    ty = __fmul_rn(2.0f, ty);
    tz = __fmul_rn(2.0f, tz);
    cross(qx, qy, qz, tx, ty, tz, ex, ey, ez);
    points[3 * j] = __fadd_rn(xyz[3 * g], __fadd_rn(__fadd_rn(vx, __fmul_rn(qw, tx)), ex));
    points[3 * j + 1] = __fadd_rn(xyz[3 * g + 1], __fadd_rn(__fadd_rn(vy, __fmul_rn(qw, ty)), ey));
    points[3 * j + 2] = __fadd_rn(xyz[3 * g + 2], __fadd_rn(__fadd_rn(vz, __fmul_rn(qw, tz)), ez));
    gid_out[j] = g;
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
    const long long blocks = (count + K5_THREADS - 1) / K5_THREADS;
    sample_points_kernel<<<(unsigned)blocks, K5_THREADS, 0, stream>>>(
        prefix, P, xyz, log_scales, rots, lo, count, kz0, kz1, ku0, ku1, std_dev, points, gid);
    return (int)cudaGetLastError();
}
