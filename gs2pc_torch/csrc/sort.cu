// The camera sweep's two key sorts, CUB's DeviceRadixSort::SortPairs on
// uint32 keys carrying int32 gids.
//
// Replaces: torch.sort of the (tile_id << 32 | depth bits) int64 keys and
// the gather of the gids after it (the JAX package's packed key sort in
// gs2pc/ops/rasterize.py::_build_pairs).  Both sorts are stable (CUB's own)
// and run once a camera:
//   depth sort  the P Gaussians' depth bits (0xFFFFFFFF for an invalid
//               one), the values 0..P-1 (depth_keys_kernel writes both),
//               bits [0, 32): the rank order K2 writes its pairs in;
//   tile sort   the pairs' tile ids, the gids as values, bits
//               [0, ceil(log2(num_tiles))).
// A valid Gaussian's depth is positive, so the uint order of its bits is the
// float order, and a tile's pairs come out of the tile sort in (depth bits,
// gid) order: the order the int64 key sort gave.
//
// What bounds them: device memory, 8 B read and 8 B written a (key, value)
// pair in each 8-bit digit pass: 4 passes over P and, for the tiles of
// either benchmark camera (4,320 and 6,370, 13 bits), 2 over the pairs.
// Against the 64-bit sort that is ~36 B a pair where it was ~300.
// The sorts run on the caller's stream between the caller's arrays and a
// scratch buffer the caller allocates (gs2pc_sort_scratch_bytes says how
// large): the alternate keys and values, then CUB's temporary storage, each
// at a 256-byte boundary.  Nothing here allocates.
#include <cub/device/device_radix_sort.cuh>

#include "common.cuh"

static size_t aligned(size_t bytes) { return (bytes + 255) & ~(size_t)255; }

GS2PC_API int gs2pc_sort_scratch_bytes(long long n, int end_bit, unsigned long long* bytes) {
    size_t temp = 0;
    cudaError_t err = cudaSuccess;
    if (n > 0) {
        cub::DoubleBuffer<unsigned> keys(nullptr, nullptr);
        cub::DoubleBuffer<int> vals(nullptr, nullptr);
        err = cub::DeviceRadixSort::SortPairs(nullptr, temp, keys, vals, (int)n, 0, end_bit);
    }
    *bytes = 2 * aligned(4 * (size_t)n) + temp;
    return (int)err;
}

__global__ void depth_keys_kernel(const unsigned* __restrict__ depth_bits,
                                  const uint8_t* __restrict__ valid, int P,
                                  unsigned* __restrict__ keys, int* __restrict__ vals) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= P) return;
    keys[g] = valid[g] ? depth_bits[g] : 0xFFFFFFFFu;
    vals[g] = g;
}

// The depth sort's input: keys[g] = the depth's bits (0xFFFFFFFF where
// invalid), vals[g] = g.
GS2PC_API int gs2pc_depth_keys(const void* depth, const void* valid, int P, void* keys,
                               void* vals, void* stream) {
    if (P > 0) {
        depth_keys_kernel<<<(P + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
            (const unsigned*)depth, (const uint8_t*)valid, P, (unsigned*)keys, (int*)vals);
    }
    return (int)cudaGetLastError();
}

// Sorts the n (key, value) pairs in keys / vals on bits [0, end_bit);
// *sorted_keys / *sorted_vals point to where the result is (the inputs or
// their alternates in scratch); the other halves hold garbage.
GS2PC_API int gs2pc_sort_pairs(void* keys, void* vals, long long n, int end_bit, void* scratch,
                               unsigned long long scratch_bytes, void** sorted_keys,
                               void** sorted_vals, void* stream) {
    *sorted_keys = keys;
    *sorted_vals = vals;
    if (n <= 0) return (int)cudaGetLastError();
    const size_t half = aligned(4 * (size_t)n);
    char* s = (char*)scratch;
    cub::DoubleBuffer<unsigned> k((unsigned*)keys, (unsigned*)s);
    cub::DoubleBuffer<int> v((int*)vals, (int*)(s + half));
    size_t temp = (size_t)scratch_bytes - 2 * half;
    cudaError_t err = cub::DeviceRadixSort::SortPairs(s + 2 * half, temp, k, v, (int)n, 0,
                                                      end_bit, (cudaStream_t)stream);
    *sorted_keys = k.Current();
    *sorted_vals = v.Current();
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
