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

// x / d rounded to nearest, from r = 1 / d rounded to nearest (computed
// once by the caller): q = x r is within an ulp of x / d, the residual
// x - q d is exact in one fma, and one more fma rounds q + (x - q d) r to
// the correctly rounded quotient (Markstein's correction; x, d and the
// quotient far from the f32 overflow and underflow ranges).  It spares the
// compiler's division its slow-path call and the registers that call
// saves.
__device__ __forceinline__ float div_rn(float x, float d, float r) {
    const float q = x * r;
    return fmaf(fmaf(-q, d, x), r, q);
}
