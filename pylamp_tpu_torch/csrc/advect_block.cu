// Per-shard RK4 marker advection on the exchanged velocity windows, all
// shards of the in-process mesh in one launch.
//
// Replaces: pylamp_tpu/markers/pallas/advect_kernel.py:advect_block_pallas.
//
// Bound on the H100: memory.  At FK 1024^2 x K18 on the 4x2 mesh each
// shard reads its own (256, 512, 18) x, y (f32) and valid (u8) -- 21 MB --
// and writes the new x, y (19 MB): ~0.32 GB over the 8 shards, ~0.1 ms at
// 3.35 TB/s; ~200 flops per marker.
//
// Design: kernel 3's tiled RK4 on live slots (advect_tile.cuh, the one
// body of kernels 3 and 11) on every shard, blockIdx.z the shard.  A block
// owns a tile of ty x tx own cells of one shard's by x bx block
// (markers/kernels/advect.py advect_plan on (by, bx): tiles of 3 x 32
// cells at 256x512 x K18, 16 x 86 x 8 = 11,008 blocks; the last tile row
// of a shard holds one cell row).
//   - Slots: own cell (r, c) of shard s at ((s by + r) bx + c) K; its
//     global cell (row_base + r, col_base + c) is the one rk4_marker gets.
//   - Velocities: the shard's windows vx_ext / vy_ext, (S, by + 2R + 1,
//     bx + 2R + 1) with R = reach; window (q, l) holds padded node
//     (row_base + q - R, col_base + l - R).  The tile's window in shared
//     memory (the tile and MARGIN = 3 nodes on each side, in global padded
//     coordinates) takes the nodes the shard's window holds and 0 for the
//     rest: the shift-window mask (reach <= R) never reads those.
//   - The lattices clamp at the global extents, so fed windows cut from
//     kernel 3's padded lattices a marker's new position is kernel 3's.
//     dt is read from device memory (no host sync).
//   - Periodic side walls (kernel 11p, the P instantiation; port-only:
//     the reference keeps its block kernels off under periodic walls):
//     the windows' columns beyond the x seam hold the wrapped columns
//     (the ring exchange gives those of kernel 3p's wrapped planes), x is
//     sampled without a clamp and never clipped at a side wall: the new x
//     wraps into [0, lx) with kernel 3p's two-rounding formula xn - lx *
//     floor(xn * (1 / lx)), so the position is kernel 3p's.  A marker
//     written past the seam stays in its slot until kernel 12p moves it
//     into the cell its x names, on the far shard.
#include "common.cuh"
#include "advect_tile.cuh"

namespace {

using namespace advect_tile;

template <bool P>
__global__ void __launch_bounds__(NT, 5)
advect_block_kernel(const AdvectArgs a, const float* __restrict__ vx_ext,
                    const float* __restrict__ vy_ext,
                    const int* __restrict__ bases, int by, int bx) {
    const int s = blockIdx.z;
    const int row_base = bases[2 * s], col_base = bases[2 * s + 1];
    const int c0 = blockIdx.x * a.tx, r0 = blockIdx.y * a.ty;
    const Tile t{row_base + r0, col_base + c0, min(a.ty, by - r0),
                 min(a.tx, bx - c0), (s * by + r0) * bx + c0, bx};
    const int R = a.reach;
    const int wr = by + 2 * R + 1, wc = bx + 2 * R + 1;
    const long long w = static_cast<long long>(s) * wr * wc;
    tile_rk4<P>(
        a, Plane{vx_ext + w, wr, wc, row_base - R, col_base - R, wc},
        Plane{vy_ext + w, wr, wc, row_base - R, col_base - R, wc}, t);
}

using KernelFn = void (*)(const AdvectArgs, const float*, const float*,
                          const int*, int, int);

KernelFn pick(int periodic) {
    return periodic ? advect_block_kernel<true> : advect_block_kernel<false>;
}

}  // namespace

// bases: (S, 2) int32 on the device, each shard's first own cell (row,
// col); vx_ext, vy_ext: (S, by + 2 reach + 1, bx + 2 reach + 1).
// periodic: the P form, x wrapped into [0, lx) with inv_lx = 1 / lx
// rounded to f32.  ty, tx, cap: the tile and the slots a round of
// markers/kernels/advect.py advect_plan(by, bx, K).
PYLAMP_EXPORT int launch_advect_block(const float* x, const float* y,
                                      const unsigned char* valid,
                                      const float* vx_ext,
                                      const float* vy_ext, const int* bases,
                                      const float* dt, float* out_x,
                                      float* out_y, int S, int ny, int nx,
                                      int by, int bx, int K, float dx,
                                      float dy, float x_lo, float x_hi,
                                      float y_lo, float y_hi, int reach,
                                      int periodic, float lx, float inv_lx,
                                      int ty, int tx, int cap,
                                      cudaStream_t stream) {
    if (S < 1 || ny < 1 || nx < 1 || by < 1 || bx < 1 ||
        (reach != 1 && reach != 2) || !plan_ok(K, ty, tx, cap) ||
        static_cast<long long>(S) * by * bx >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const AdvectArgs a{x,     y,  valid, dt,   out_x, out_y, ny,
                       nx,    K,  ty,    tx,   cap,   reach, dx,
                       dy,    x_lo, x_hi, y_lo, y_hi, lx, inv_lx,
                       1.0f / dx, 1.0f / dy};
    const int smem = Layout(ty, tx, cap).total;
    const KernelFn kernel = pick(periodic);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((bx + tx - 1) / tx, (by + ty - 1) / ty, S);
    kernel<<<grid, NT, smem, stream>>>(a, vx_ext, vy_ext, bases, by, bx);
    return launch_status();
}

// Occupancy of the kernel (periodic: its P form) at tiles of ty x tx
// cells and rounds of cap slots: out as advect_tile.cuh kernel_info's.
PYLAMP_EXPORT int advect_block_kernel_info(int ty, int tx, int cap,
                                           int periodic, int* out) {
    return kernel_info(reinterpret_cast<const void*>(pick(periodic)), ty, tx,
                       cap, out);
}
