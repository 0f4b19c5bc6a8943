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
// Design: kernel 1's tiled stencil (saddle_tile.cuh, PR = false) without
// the pressure plane and the continuity row.  A block of 32 x 8 threads
// stages a 16 x 32 tile of the (ny+1, nx+1) point space and a one-point
// ring (vx, vy, eta_s, eta_n) in shared memory, the wall ghosts resolved
// at the load; sxy is computed once per corner; the rows use SweepConsts'
// hoisted reciprocals (the 1e-5 bar of kernel 1's reassociation); a tile
// that touches no ghost, Dirichlet line or seam takes the branch-free
// form.  kbnd comes from device memory, so an apply never syncs the host,
// and the level's constants arrive as one struct built once per solve
// (ops/kernels/momentum.py).  Periodic side walls (P, launched when
// `periodic` is set): the thread of column 0 computes the seam's half row
// once and writes it to both seam columns, so they are bit-identical.
#include "common.cuh"
#include "saddle_tile.cuh"

namespace {

using namespace saddle_tile;

template <bool P>
__global__ void __launch_bounds__(NT)
momentum_kernel(const Fields f, const SweepConsts c) {
    __shared__ Planes<false> s;
    apply_tile<P, false>(s, f, c);
}

}  // namespace

PYLAMP_EXPORT int launch_momentum(const float* vx, const float* vy,
                                  float* rx, float* ry, const SaddleArgs* args,
                                  cudaStream_t stream) {
    const SaddleArgs& a = *args;
    const SweepConsts c = sweep_consts(a.ny, a.nx, a.dx, a.dy, a.s_top,
                                       a.s_bottom, a.s_left, a.s_right);
    const int W1 = a.nx + 1, W = a.nx;  // row strides: vx lattice, cells
    const Fields f{{vx, W1}, {vy, W}, {a.eta_s, W1}, {a.eta_n, W},
                   {nullptr, W}, a.kk, nullptr, {rx, W1}, {ry, W},
                   {nullptr, W}};
    const dim3 block(TX, BY), grid = tile_grid(a.ny, a.nx);
    if (a.periodic)
        momentum_kernel<true><<<grid, block, 0, stream>>>(f, c);
    else
        momentum_kernel<false><<<grid, block, 0, stream>>>(f, c);
    return launch_status();
}

// Occupancy of the kernel (periodic: its P form): out as
// saddle_kernel_info's.
PYLAMP_EXPORT int momentum_kernel_info(int periodic, int* out) {
    return kernel_info(
        periodic ? reinterpret_cast<const void*>(momentum_kernel<true>)
                 : reinterpret_cast<const void*>(momentum_kernel<false>),
        out);
}
