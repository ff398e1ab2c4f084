// K6 -- the per-camera front end: projection, EWA 2D covariance, conic,
// radii, tile rect, tiles_touched, valid, and the Gaussian's blend-table row.
//
// Replaces: the one XLA fusion the JAX package compiles per camera from
// gs2pc/ops/projection.py::preprocess (:47) and
// gs2pc/ops/rasterize.py::pack_blend_table (:526) ("the concat fuses
// straight into the preprocess").  Run eagerly, the port's twin of the two
// (gs2pc_torch/ops/projection.py::preprocess_torch + rasterize.
// pack_blend_table) is ~190 launches a camera, each a full pass over the
// Gaussian axis.
//
// One thread per Gaussian, one launch per camera.  It reads the mean, the
// covariance factor, the opacity, the alive flag and (with a table) the
// colour: 53 B, 65 B with the colour; and writes every field of
// Preprocessed that is not an input (57 B) and the table row (32 B
// compact, 64 B full).  ~300 float operations a Gaussian against ~150 B
// moved, so device memory bounds it (chip_smoke.k6_bound); the design does
// nothing more about that than touch each byte once.  The camera (two 4x4
// matrices, tan fov and focal lengths) is read from the camera's own
// device tensors into shared memory, so a camera costs the host no sync.
//
// Bit-equal to the twin on the card: every float operation is the twin's,
// in the twin's order, rounded to nearest with no FMA contraction
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn; the twin's 1.0 / x is
// torch's reciprocal, an IEEE division); the twin's three-term sums are
// written out left to right (projection.py pins them the same way); Python
// scalars enter as the float the double rounds to, as torch casts them;
// torch.maximum / minimum / clamp pass a NaN operand through; logf, sqrtf,
// ceilf, floorf, nearbyintf are the functions PyTorch's CUDA kernels call;
// float -> int casts are cvt.rzi (NaN -> 0), as torch's .to(int32) on the
// card.  _tile_index clamps in float before the cast, so infinite, NaN and
// behind-camera rows get the twin's rects.
#include "common.cuh"

#define K6_THREADS 256

namespace {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }

// torch.maximum / torch.minimum / clamp on the card: a NaN operand is
// returned as it is, the first one first.
__device__ __forceinline__ float tmax(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}

// One row of affine3 / dotrow3: ((r0 x + r1 y) + r2 z) + r3.
__device__ __forceinline__ float row_dot(const float* r, float x, float y, float z) {
    return add(add(add(mul(r[0], x), mul(r[1], y)), mul(r[2], z)), r[3]);
}

// ndc2pix: ((v + 1) * size - 1) * 0.5.
__device__ __forceinline__ float ndc2pix(float v, float size) {
    return mul(sub(mul(add(v, 1.0f), size), 1.0f), 0.5f);
}

// _tile_index: floor(x / TILE) (torch divides by a Python scalar as a
// product with its reciprocal), clamped to [-1, hi + 1] in float, cast,
// clamped to [0, hi].
__device__ __forceinline__ int tile_index(float x, int hi) {
    const float f = tmin(tmax(floorf(mul(x, 1.0f / TILE_EDGE)), -1.0f), (float)hi + 1.0f);
    return min(max(__float2int_rz(f), 0), hi);
}

// clamp(c, 0, 1) * 255, rounded half to even, as an int (NaN -> 0).
__device__ __forceinline__ int quantise(float c) {
    return __float2int_rz(nearbyintf(mul(tmin(tmax(c, 0.0f), 1.0f), 255.0f)));
}

}  // namespace

// Shared camera block: view (16), proj (16), limx, limy, focal_x, focal_y.
#define CAM_VIEW 0
#define CAM_PROJ 16
#define CAM_LIMX 32
#define CAM_LIMY 33
#define CAM_FX 34
#define CAM_FY 35
#define CAM_FLOATS 36

__global__ void __launch_bounds__(K6_THREADS) project_pack_kernel(
    const float* __restrict__ means, const float* __restrict__ factors,
    const float* __restrict__ opacities, const uint8_t* __restrict__ alive,
    const float* __restrict__ colours, const float* __restrict__ viewmatrix,
    const float* __restrict__ projmatrix, const float* __restrict__ tanfovx,
    const float* __restrict__ tanfovy, const float* __restrict__ focal_x,
    const float* __restrict__ focal_y, int P, int width, int height, int adaptive, int lanes,
    float* __restrict__ depth_out, float* __restrict__ xy_out, float* __restrict__ conic_out,
    float* __restrict__ radius_out, float* __restrict__ r_alpha_sq_out,
    float* __restrict__ radius_q_out, int* __restrict__ rect_min_out,
    int* __restrict__ rect_max_out, int* __restrict__ tiles_out, uint8_t* __restrict__ valid_out,
    float* __restrict__ table) {
    __shared__ float cam[CAM_FLOATS];
    const int t = threadIdx.x;
    if (t < 16) {
        cam[CAM_VIEW + t] = viewmatrix[t];
        cam[CAM_PROJ + t] = projmatrix[t];
    } else if (t == 16) {
        cam[CAM_LIMX] = mul((float)1.3, tanfovx[0]);
    } else if (t == 17) {
        cam[CAM_LIMY] = mul((float)1.3, tanfovy[0]);
    } else if (t == 18) {
        cam[CAM_FX] = focal_x[0];
    } else if (t == 19) {
        cam[CAM_FY] = focal_y[0];
    }
    __syncthreads();
    const int g = blockIdx.x * K6_THREADS + t;
    if (g >= P) return;
    const size_t i = (size_t)g;
    const float* V = cam + CAM_VIEW;
    const float* Pm = cam + CAM_PROJ;

    // View and clip transforms (affine3, dotrow3).
    const float x = means[3 * i], y = means[3 * i + 1], z = means[3 * i + 2];
    const float vx = row_dot(V, x, y, z), vy = row_dot(V + 4, x, y, z);
    const float depth = row_dot(V + 8, x, y, z);
    const bool in_front = depth > (float)0.2;
    const float hx = row_dot(Pm, x, y, z), hy = row_dot(Pm + 4, x, y, z);
    const float inv_w = quo(1.0f, add(row_dot(Pm + 12, x, y, z), (float)1e-7));
    const float px = ndc2pix(mul(hx, inv_w), (float)width);
    const float py = ndc2pix(mul(hy, inv_w), (float)height);

    // EWA 2D covariance on the factor: M2 = J W M3, cov2D = M2 M2^T + 0.3 I.
    const float limx = cam[CAM_LIMX], limy = cam[CAM_LIMY];
    const float tz = fabsf(depth) < (float)1e-6 ? (float)1e-6 : depth;
    const float tx = mul(tmin(tmax(quo(vx, tz), -limx), limx), tz);
    const float ty = mul(tmin(tmax(quo(vy, tz), -limy), limy), tz);
    float F[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) F[k] = factors[9 * i + k];
    float T[3][3];  // rot_factors3: T[r][k] = (R[r,0] F[0,k] + R[r,1] F[1,k]) + R[r,2] F[2,k]
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k)
            T[r][k] = add(add(mul(V[4 * r], F[k]), mul(V[4 * r + 1], F[3 + k])),
                          mul(V[4 * r + 2], F[6 + k]));
    const float inv_z = quo(1.0f, tz);
    const float fx = cam[CAM_FX], fy = cam[CAM_FY];
    const float a0 = mul(fx, inv_z), b0 = mul(mul(mul(fx, tx), inv_z), inv_z);
    const float a1 = mul(fy, inv_z), b1 = mul(mul(mul(fy, ty), inv_z), inv_z);
    float r0[3], r1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        r0[k] = sub(mul(a0, T[0][k]), mul(b0, T[2][k]));
        r1[k] = sub(mul(a1, T[1][k]), mul(b1, T[2][k]));
    }
    const float h_var = (float)0.3;
    const float cov_a =
        add(add(add(mul(r0[0], r0[0]), mul(r0[1], r0[1])), mul(r0[2], r0[2])), h_var);
    const float cov_b = add(add(mul(r0[0], r1[0]), mul(r0[1], r1[1])), mul(r0[2], r1[2]));
    const float cov_c =
        add(add(add(mul(r1[0], r1[0]), mul(r1[1], r1[1])), mul(r1[2], r1[2])), h_var);
    const float det = sub(mul(cov_a, cov_c), mul(cov_b, cov_b));
    const bool invertible = det > 0.0f;
    const float det_inv = quo(1.0f, invertible ? det : 1.0f);
    const float cA = mul(cov_c, det_inv), cB = mul(-cov_b, det_inv), cC = mul(cov_a, det_inv);

    // Radii: the 3-sigma bound, and the AdR radius where alpha can still
    // reach 1/255 (or the 3.4e38 sentinel in full-rect mode).
    const float mid = mul(0.5f, add(cov_a, cov_c));
    const float disc = sqrtf(tmax(sub(mul(mid, mid), det), (float)0.1));
    const float lam = tmax(add(mid, disc), 0.0f);
    const float op = opacities[i];
    const float ln_term = logf(tmax(mul(255.0f, op), (float)1e-12));
    const float r_true =
        add(mul(mul(mul(2.0f, lam), tmax(ln_term, 0.0f)), (float)1.0001), (float)1e-3);
    const float r_sq = adaptive ? r_true : (float)3.4e38;
    const float nine_lam = mul(9.0f, lam);
    const float radius = ceilf(sqrtf(tmin(nine_lam, r_sq)));
    const float radius_q = ceilf(sqrtf(tmin(nine_lam, r_true)));

    // Tile rect, its tile count, and validity.
    const int grid_w = (width + TILE_EDGE - 1) / TILE_EDGE;
    const int grid_h = (height + TILE_EDGE - 1) / TILE_EDGE;
    const int x0 = tile_index(sub(px, radius), grid_w);
    const int y0 = tile_index(sub(py, radius), grid_h);
    const int x1 = tile_index(sub(add(add(px, radius), (float)TILE_EDGE), 1.0f), grid_w);
    const int y1 = tile_index(sub(add(add(py, radius), (float)TILE_EDGE), 1.0f), grid_h);
    const int tiles = (x1 - x0) * (y1 - y0);
    const bool valid = alive[i] && in_front && invertible && tiles > 0 &&
                       op >= (float)(1.0 / 255.0);

    depth_out[i] = depth;
    reinterpret_cast<float2*>(xy_out)[i] = make_float2(px, py);
    conic_out[3 * i] = cA;
    conic_out[3 * i + 1] = cB;
    conic_out[3 * i + 2] = cC;
    radius_out[i] = radius;
    r_alpha_sq_out[i] = r_sq;
    radius_q_out[i] = radius_q;
    reinterpret_cast<int2*>(rect_min_out)[i] = make_int2(x0, y0);
    reinterpret_cast<int2*>(rect_max_out)[i] = make_int2(x1, y1);
    tiles_out[i] = tiles;
    valid_out[i] = valid ? 1 : 0;
    if (lanes == 0) return;

    // The blend row: [x y A B C opacity depth rgb24] or
    // [x y A B C opacity depth 0 | r g b 0 0 0 0 0].
    const float c0 = colours[3 * i], c1 = colours[3 * i + 1], c2 = colours[3 * i + 2];
    float4* row = reinterpret_cast<float4*>(table + i * lanes);
    row[0] = make_float4(px, py, cA, cB);
    if (lanes == 8) {
        const int rgb24 = (quantise(c0) << 16) | (quantise(c1) << 8) | quantise(c2);
        row[1] = make_float4(cC, op, depth, __int2float_rn(rgb24));
    } else {
        row[1] = make_float4(cC, op, depth, 0.0f);
        row[2] = make_float4(c0, c1, c2, 0.0f);
        row[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
}

// One launch for one camera.  ``colours`` and ``table`` may be NULL when
// ``lanes`` is 0 (no table); otherwise lanes is 8 (compact) or 16.
GS2PC_API int gs2pc_project_pack(const void* means, const void* factors, const void* opacities,
                                 const void* alive, const void* colours,
                                 const void* viewmatrix, const void* projmatrix,
                                 const void* tanfovx, const void* tanfovy, const void* focal_x,
                                 const void* focal_y, int P, int width, int height, int adaptive,
                                 int lanes, void* depth, void* xy, void* conic, void* radius,
                                 void* r_alpha_sq, void* radius_q, void* rect_min,
                                 void* rect_max, void* tiles_touched, void* valid, void* table,
                                 void* stream) {
    if (lanes != 0 && lanes != 8 && lanes != 16) return (int)cudaErrorInvalidValue;
    if (P > 0) {
        project_pack_kernel<<<(P + K6_THREADS - 1) / K6_THREADS, K6_THREADS, 0,
                              (cudaStream_t)stream>>>(
            (const float*)means, (const float*)factors, (const float*)opacities,
            (const uint8_t*)alive, (const float*)colours, (const float*)viewmatrix,
            (const float*)projmatrix, (const float*)tanfovx, (const float*)tanfovy,
            (const float*)focal_x, (const float*)focal_y, P, width, height, adaptive, lanes,
            (float*)depth, (float*)xy, (float*)conic, (float*)radius, (float*)r_alpha_sq,
            (float*)radius_q, (int*)rect_min, (int*)rect_max, (int*)tiles_touched,
            (uint8_t*)valid, (float*)table);
    }
    return (int)cudaGetLastError();
}
