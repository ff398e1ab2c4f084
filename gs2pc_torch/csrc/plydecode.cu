// The scene load's record decode: one block of a binary little-endian 3DGS
// export's vertex records, as read from the file, into rows lo.. of the
// scene's planes (xyz, colours, log_scales, rots, and shs on request).
//
// Replaces no TPU kernel: the JAX package decodes the records on the host
// (gs2pc/io/ply.py::load_ply_gaussians), as the port's host path does with
// numpy on a few threads (gs2pc_torch/io/gaussians_io.py::_Planes.fill),
// about 30 passes a block while the card waits.  On a card the host threads
// only read each block into pinned memory, compute the opacity's sigmoid
// (numpy's float32 exp is not correctly rounded, so it stays on the host)
// and copy the block over; this kernel takes every other plane from it.
//
// One thread a row, one launch a block (at most CARD_BLOCK_ROWS rows).  It reads
// the row's 13 fields out of a 248-B record (all of it with shs) and writes
// 52 B (240 B with shs): device memory bounds it, and the block was just
// copied in, so it is mostly read from L2.  Nothing in its design goes
// further: the block's copy over PCIe takes ~17x its time.
//
// Bit-equal to _Planes.fill on an x86-64 host, and to its twin
// (gs2pc_torch/ops/plydecode.py::ply_decode_torch): the same float32
// operations in the same order, rounded to nearest with no FMA contraction
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn); the squares summed
// ((s0 + s1) + s2) + s3, as np.linalg.norm's reduction over a row of four;
// numpy's float32 constants as their bits; NaNs as SSE gives them (a NaN
// operand comes out quieted, the first one first; an invalid operation
// gives the default NaN 0xFFC00000), where the card would give its
// canonical NaN; np.clip and np.maximum pass a NaN through; NaN cast to
// uint8 is 0; copies move the bits.
#include "common.cuh"

#define PLY_THREADS 256
// f_rest_* fields a record may have: degree 3, the most 3DGS exports.
#define PLY_MAX_REST 45

namespace {

// Byte offsets in a record: x y z, f_dc_0..2, scale_0..2, rot_0..3, then
// the f_rest_* fields in the order of their numbers.
struct RecordLayout {
    int stride;
    int field[13];
    int n_rest;
    int rest[PLY_MAX_REST];
};

// float32(0.28209479177387814), float32(1e-12), float32(1 / 255): the
// float32 numpy rounds each Python scalar to.
#define PLY_SH_C0_BITS 0x3e906ebbu
#define PLY_EPS_BITS 0x2b8cbcccu
#define PLY_INV255_BITS 0x3b808081u
#define PLY_DEFAULT_NAN_BITS 0xffc00000u

__device__ __forceinline__ bool is_nan(float a) { return a != a; }

__device__ __forceinline__ float quiet(float a) {
    return __int_as_float(__float_as_int(a) | 0x00400000);
}

// The result r of a op b as SSE returns it.
__device__ __forceinline__ float sse(float a, float b, float r) {
    return is_nan(a) ? quiet(a)
         : is_nan(b) ? quiet(b)
         : is_nan(r) ? __uint_as_float(PLY_DEFAULT_NAN_BITS) : r;
}

__device__ __forceinline__ float mul(float a, float b) { return sse(a, b, __fmul_rn(a, b)); }
__device__ __forceinline__ float add(float a, float b) { return sse(a, b, __fadd_rn(a, b)); }
__device__ __forceinline__ float quo(float a, float b) { return sse(a, b, __fdiv_rn(a, b)); }
__device__ __forceinline__ float root(float a) { return sse(a, 0.0f, __fsqrt_rn(a)); }

// np.clip(v, 0.0, 1.0): min(max(v, 0), 1), a NaN passed through.
__device__ __forceinline__ float clip01(float v) {
    if (is_nan(v)) return v;
    v = v > 0.0f ? v : 0.0f;
    return v < 1.0f ? v : 1.0f;
}

__device__ __forceinline__ uint32_t bits_at(const uint8_t* rec, int offset) {
    return *reinterpret_cast<const uint32_t*>(rec + offset);
}

__device__ __forceinline__ float float_at(const uint8_t* rec, int offset) {
    return __uint_as_float(bits_at(rec, offset));
}

__global__ void __launch_bounds__(PLY_THREADS)
ply_decode_kernel(const uint8_t* __restrict__ records, int rows, RecordLayout layout,
                  long long lo, int compact, uint32_t* __restrict__ xyz,
                  float* __restrict__ colours, uint32_t* __restrict__ log_scales,
                  float* __restrict__ rots, uint32_t* __restrict__ shs) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= rows) return;
    const uint8_t* rec = records + (size_t)i * layout.stride;
    const long long row = lo + i;

    for (int c = 0; c < 3; ++c) {
        xyz[row * 3 + c] = bits_at(rec, layout.field[c]);
        log_scales[row * 3 + c] = bits_at(rec, layout.field[6 + c]);
    }

    // colours = clip(SH_C0 * f_dc + 0.5, 0, 1), then _quantise_u8.
    const float c0 = __uint_as_float(PLY_SH_C0_BITS);
    for (int c = 0; c < 3; ++c) {
        float v = clip01(add(mul(c0, float_at(rec, layout.field[3 + c])), 0.5f));
        if (compact) {
            const float t = rintf(mul(v, 255.0f));
            const int q = is_nan(t) ? 0 : (int)t;
            v = mul((float)q, __uint_as_float(PLY_INV255_BITS));
        }
        colours[row * 3 + c] = v;
    }

    // rots = r / max(norm(r), 1e-12), negated where the divided r0 < 0.
    float r[4];
    for (int j = 0; j < 4; ++j) r[j] = float_at(rec, layout.field[9 + j]);
    const float sum = add(add(add(mul(r[0], r[0]), mul(r[1], r[1])), mul(r[2], r[2])),
                          mul(r[3], r[3]));
    float norm = root(sum);
    const float eps = __uint_as_float(PLY_EPS_BITS);
    norm = (is_nan(norm) || norm >= eps) ? norm : eps;
    for (int j = 0; j < 4; ++j) r[j] = quo(r[j], norm);
    const int flip = r[0] < 0.0f ? (int)0x80000000 : 0;
    for (int j = 0; j < 4; ++j) rots[row * 4 + j] = __int_as_float(__float_as_int(r[j]) ^ flip);

    if (shs != nullptr) {
        // (3, K) a row, channel-major: f_dc, then f_rest in number order.
        const int per = layout.n_rest / 3;
        uint32_t* out = shs + row * 3 * (per + 1);
        for (int c = 0; c < 3; ++c) out[c * (per + 1)] = bits_at(rec, layout.field[3 + c]);
        for (int j = 0; j < layout.n_rest; ++j)
            out[(j / per) * (per + 1) + 1 + j % per] = bits_at(rec, layout.rest[j]);
    }
}

}  // namespace

// offsets: stride, the 13 fields, then the n_offsets - 14 f_rest fields.
GS2PC_API int gs2pc_ply_decode(const void* records, int rows, const int* offsets,
                               int n_offsets, long long lo, int compact, void* xyz,
                               void* colours, void* log_scales, void* rots, void* shs,
                               void* stream) {
    const int n_rest = n_offsets - 14;
    if (n_rest < 0 || n_rest > PLY_MAX_REST || n_rest % 3 != 0)
        return (int)cudaErrorInvalidValue;
    RecordLayout layout;
    layout.stride = offsets[0];
    for (int j = 0; j < 13; ++j) layout.field[j] = offsets[1 + j];
    layout.n_rest = n_rest;
    for (int j = 0; j < n_rest; ++j) layout.rest[j] = offsets[14 + j];
    if (rows > 0) {
        ply_decode_kernel<<<(rows + PLY_THREADS - 1) / PLY_THREADS, PLY_THREADS, 0,
                            (cudaStream_t)stream>>>(
            (const uint8_t*)records, rows, layout, lo, compact, (uint32_t*)xyz,
            (float*)colours, (uint32_t*)log_scales, (float*)rots, (uint32_t*)shs);
    }
    return (int)cudaGetLastError();
}
