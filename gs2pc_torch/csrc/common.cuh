// Shared helpers of the gs2pc_torch CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GS2PC_API extern "C" __attribute__((visibility("default")))

// Pixels per tile edge; one CTA of TILE_EDGE^2 threads blends one tile.
#define TILE_EDGE 16
#define TILE_PIXELS (TILE_EDGE * TILE_EDGE)
