// Shared helpers of the hand-written Hopper kernels (see cuda_build.py).
#pragma once

#include <cuda_runtime.h>

#define PYLAMP_EXPORT extern "C" __attribute__((visibility("default")))

// Grid of 2-D thread blocks covering a (rows, cols) index space.
static inline dim3 grid2d(int rows, int cols, dim3 block) {
    return dim3((cols + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
}

// Launch status: the error the launch itself raised (a refused
// configuration never runs, and a later synchronize would not report it).
static inline int launch_status() {
    return static_cast<int>(cudaGetLastError());
}
