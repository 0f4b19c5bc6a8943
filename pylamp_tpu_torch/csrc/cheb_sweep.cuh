// The Chebyshev smoother's pointwise pieces, shared by the fused sweep
// (cheb.cu) and the fused coarse sub-V-cycle (coarse_vcycle.cu), on top of
// the momentum stencil of stencil.cuh.  The role of
// pylamp_tpu/ops/pallas/cheb_block_kernel.py:frame_cheb_sweep.
//
// The Dirichlet lines have diagonal kbnd and operator row kbnd * v
// (stencil.cuh), so the recurrence updates them pointwise like every other
// point.
#pragma once

#include "stencil.cuh"

// One Chebyshev update of a recurrence state: k = 0 starts it from the
// residual alone (c1_0 = 0), later k carry the previous step.
__device__ __forceinline__ float cheb_step(int k, float c1, float c2,
                                           float prev, float resid, float diag) {
    return (k == 0) ? c2 * resid / diag : c1 * prev + c2 * resid / diag;
}
