// Full Stokes saddle-point apply (rx, ry, rc) for the FGMRES outer
// iterations.
//
// Replaces: pylamp_tpu/ops/pallas/stokes_kernel.py:saddle_apply_pallas
// (with prep_eta_pallas).
//
// Bound on the H100: memory.  Per call at 1024^2 it reads vx, vy, p,
// eta_s, eta_n (5.25 M floats, 21 MB) and writes rx, ry, rc (3.15 M
// floats, 12.6 MB): ~34 MB, ~10 us at 3.35 TB/s, against ~25 flops per
// output point.
//
// Design: a tiled stencil in shared memory.
//   - A block of 32 x 8 threads owns a tile of TY x TX = 16 x 32 points of
//     the (ny+1, nx+1) point space, two rows a thread: point (j, i)
//     carries vx(j, i) when j < ny, vy(j, i) when i < nx, the corner
//     viscosity eta_s(j, i) and, in a cell, eta_n and p.  It stages vx, vy, eta_s, eta_n and p for the tile
//     and a one-point ring into five planes of row stride SX = TX + 2
//     (coalesced row loads; the planes with nx + 1 columns have a row
//     pitch that is no multiple of 16 bytes, so plain 4-byte loads).  The
//     wall ghosts are resolved at the load (ghost = s * first interior row
//     or column, as ops/stokes.py pads); under periodic side
//     walls vy's ghost columns are the wrapped columns.
//   - The shear stress sxy is computed once per corner of the tile into a
//     shared plane (a point-at-a-time stencil computes each corner up to
//     four times), then rx, ry and rc are formed from the planes.
//   - The arithmetic is sweep_stencil.cuh's: SweepConsts' hoisted 1/dx,
//     1/dy, 2/dx^2 and 2/dy^2 multiply where the plain version divides,
//     so no IEEE division is left.  That reassociation moves each result by a
//     few f32 units in the last place against the plain version (the bar
//     is 1e-5 of max |ref|, as for kernel 5).
//   - A tile whose staged frame holds no ghost and no Dirichlet or seam
//     point takes the branch-free form; only edge tiles test for walls.
//   - kbnd / kcont come from a 2-element device array, so a solve never
//     syncs the host for them.  The per-solve constants arrive as one
//     struct (ops/kernels/saddle.py builds it once per solve).
// Periodic side walls (template switch P, launched when `periodic` is
// set): the seam columns 0 and nx are one node whose row is the wrapped
// equation, half of it in each column (ops/stokes.py's convention: sxx of
// cells 0 and nx - 1 with vx columns 0, 1, nx - 1 and nx, sxy of corner
// column 0, half the wrapped pressure gradient).  The thread of column 0
// computes that half row once and writes it to both columns, so they are
// bit-identical; the thread of column nx writes nothing to rx.  The seam
// adds O(ny) work to O(ny nx).
// The tile body (saddle_tile.cuh) is shared with the MG momentum apply
// (kernel 7, momentum.cu), which drops the pressure and continuity rows,
// and with the per-shard saddle stencil (kernel 9, saddle_block.cu),
// which runs it on every shard's extended blocks.
#include "common.cuh"
#include "saddle_tile.cuh"

namespace {

using namespace saddle_tile;

template <bool P>
__global__ void __launch_bounds__(NT)
saddle_kernel(const Fields f, const SweepConsts c) {
    __shared__ Planes<true> s;
    apply_tile<P, true>(s, f, c);
}

}  // namespace

PYLAMP_EXPORT int launch_saddle(const float* vx, const float* vy,
                                const float* p, float* rx, float* ry,
                                float* rc, const SaddleArgs* args,
                                cudaStream_t stream) {
    const SaddleArgs& a = *args;
    const SweepConsts c = sweep_consts(a.ny, a.nx, a.dx, a.dy, a.s_top,
                                       a.s_bottom, a.s_left, a.s_right);
    const int W1 = a.nx + 1, W = a.nx;  // row strides: vx lattice, cells
    const Fields f{{vx, W1}, {vy, W}, {a.eta_s, W1}, {a.eta_n, W}, {p, W},
                   a.kk, a.kk + 1, {rx, W1}, {ry, W}, {rc, W}};
    const dim3 block(TX, BY), grid = tile_grid(a.ny, a.nx);
    if (a.periodic)
        saddle_kernel<true><<<grid, block, 0, stream>>>(f, c);
    else
        saddle_kernel<false><<<grid, block, 0, stream>>>(f, c);
    return launch_status();
}

// Occupancy of the kernel (periodic: its P form): out = {registers per
// thread, static shared bytes, local (spill) bytes per thread, resident
// blocks per SM, threads per block, dynamic shared bytes}.
PYLAMP_EXPORT int saddle_kernel_info(int periodic, int* out) {
    return kernel_info(
        periodic ? reinterpret_cast<const void*>(saddle_kernel<true>)
                 : reinterpret_cast<const void*>(saddle_kernel<false>),
        out);
}

PYLAMP_EXPORT const char* pylamp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
