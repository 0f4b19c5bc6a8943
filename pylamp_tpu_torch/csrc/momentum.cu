// MG momentum-block apply (rx, ry) = A (vx, vy): the saddle operator with
// p = 0 and no continuity row, for the momentum applies of the multigrid
// preconditioner (the inner velocity FGMRES on the fine level, and any
// apply on a level that the fused smoother does not take).
//
// Replaces: pylamp_tpu/ops/pallas/stokes_kernel.py:momentum_apply_pallas
// (with prep_eta_pallas), including the vy wall row ny that the TPU
// wrapper appended outside its kernel.
//
// Bound on the H100: memory, and at the sizes it runs, launch latency.  At
// 1024x256 it reads vx, vy, eta_s, eta_n (4 x ~263 k floats, 4.2 MB) and
// writes rx, ry (2.1 MB): ~6.3 MB, ~1.9 us at 3.35 TB/s, against ~25
// flops per output point -- below the few microseconds a launch costs.
//
// Design: one thread per point of the (ny+1, nx+1) index space, as in
// saddle.cu, with the same stencil (stencil.cuh); the thread writes rx
// where its point is a vx node and ry where it is a vy node.  Wall ghosts
// come inline from the BC signs, and kbnd comes from a 1-element device
// array, so an apply never syncs the host.  Periodic side walls: the P
// instantiation of the same stencil (stencil.cuh), whose two seam columns
// evaluate one half row and are bit-identical; P = false is unchanged.
#include "common.cuh"
#include "stencil.cuh"

namespace {

template <bool P>
__global__ void momentum_kernel(GlobalAcc a, StencilCtx c,
                                const float* __restrict__ kb,
                                float* __restrict__ rx,
                                float* __restrict__ ry) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int ny = c.ny, nx = c.nx;
    if (i > nx || j > ny) return;
    const float kbnd = kb[0];
    if (j < ny) rx[j * (nx + 1) + i] = stencil_ax<P>(a, c, j, i, kbnd);
    if (i < nx) ry[j * nx + i] = stencil_ay<P>(a, c, j, i, kbnd);
}

}  // namespace

PYLAMP_EXPORT int launch_momentum(const float* vx, const float* vy,
                                  const float* eta_s, const float* eta_n,
                                  const float* kb, float* rx, float* ry,
                                  int ny, int nx, float dx, float dy,
                                  float s_top, float s_bottom, float s_left,
                                  float s_right, int periodic,
                                  cudaStream_t stream) {
    const GlobalAcc a{vx, vy, eta_s, eta_n, nx};
    const StencilCtx c{ny, nx, dx, dy, s_top, s_bottom, s_left, s_right};
    dim3 block(32, 8);
    if (periodic)
        momentum_kernel<true><<<grid2d(ny + 1, nx + 1, block), block, 0,
                                stream>>>(a, c, kb, rx, ry);
    else
        momentum_kernel<false><<<grid2d(ny + 1, nx + 1, block), block, 0,
                                 stream>>>(a, c, kb, rx, ry);
    return launch_status();
}
