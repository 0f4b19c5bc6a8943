// Fused RK4 marker advection in the (ny, nx, K) bucket layout.
//
// Replaces: pylamp_tpu/markers/pallas/advect_kernel.py:advect_rk4_pallas.
//
// Bound on the H100: memory.  At 1024^2 x K18 (18.9 M slots) it reads
// x, y (f32) and valid (u8) -- 170 MB -- and writes the new x, y (151 MB):
// ~0.32 GB, ~0.1 ms at 3.35 TB/s.  Per marker: 32 bilinear reads (4
// stages x 2 lattices x 4 corners), ~16 IEEE divisions, ~200 flops.
//
// Design: a tile of cells a block, its velocities in shared memory and
// its lanes on live slots only (advect_tile.cuh: one body for this kernel
// and the per-shard kernel 11, advect_block.cu).
//   - A block owns a tile of TY x TX cells (markers/kernels/advect.py
//     advect_plan: 3 x 32 at K18).  It stages the tile's window of the
//     ghost-padded lattices vx_p (ny+2, nx+1) and vy_p (ny+1, nx+2) --
//     the tile plus MARGIN = 3 nodes on each side, >= the largest stage
//     reach + 1 -- in shared memory once; every one of a marker's 32
//     samples then reads shared memory (advect_rk4.cuh's Lattice with the
//     window's origin and stride; its shift-window mask keeps every read
//     inside the window).  Periodic side walls (P): the window is cut from
//     the wrapped planes the wrapper builds (advect.py wrapped_planes,
//     PADW columns of wrap on each side), x is not clamped and the new x
//     wraps into [0, lx).
//   - Lanes on live slots: the block walks its tile's slots (each tile
//     row one contiguous run, coalesced loads of x, y and valid) in rounds
//     of at most CAP slots.  An empty slot gets its output at once (its
//     position clipped to the domain, or wrapped: advect_rk4.cuh's
//     rk4_empty, the RK4 with zero velocity, as the plain version's); a
//     valid one is appended to a list in shared memory (one ballot and
//     one shared atomicAdd a warp).  Then every lane takes list entries,
//     one marker's RK4 each.  Each marker's result depends on nothing
//     else, so the list's order does not matter: the output is
//     deterministic.
//   - A slot's cell comes from the tile and a walk stepped without a
//     division; no 64-bit division a slot.
//   - The arithmetic per marker is advect_rk4.cuh's rk4_marker; its
//     divisions s / dx are common.cuh's div_rn (correctly rounded from
//     1 / dx, without the division's slow-path call).  dt is read from
//     device memory (no host sync).
#include "common.cuh"
#include "advect_tile.cuh"

namespace {

using namespace advect_tile;

template <bool P>
__global__ void __launch_bounds__(NT, 5)
advect_kernel(const AdvectArgs a, const float* __restrict__ vx_p,
              const float* __restrict__ vy_p) {
    const int ci0 = blockIdx.x * a.tx, cj0 = blockIdx.y * a.ty;
    const Tile t{cj0, ci0, min(a.ty, a.ny - cj0), min(a.tx, a.nx - ci0),
                 cj0 * a.nx + ci0, a.nx};
    if (P) {  // planes (ny + 2 | ny + 1, nx + 2 PADW), column c at c + PADW
        const int pw = a.nx + 2 * PADW;
        tile_rk4<P>(a, Plane{vx_p, a.ny + 2, pw, 0, -PADW, pw},
                       Plane{vy_p, a.ny + 1, pw, 0, -PADW, pw}, t);
    } else {
        tile_rk4<P>(a, Plane{vx_p, a.ny + 2, a.nx + 1, 0, 0, a.nx + 1},
                       Plane{vy_p, a.ny + 1, a.nx + 2, 0, 0, a.nx + 2}, t);
    }
}

template <bool P>
cudaError_t configure(int smem) {
    return cudaFuncSetAttribute(advect_kernel<P>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
}

}  // namespace

// ty, tx, cap: the tile and the slots a round of
// markers/kernels/advect.py advect_plan.
PYLAMP_EXPORT int launch_advect(const float* x, const float* y,
                                const unsigned char* valid, const float* vx_p,
                                const float* vy_p, const float* dt,
                                float* out_x, float* out_y, int ny, int nx,
                                int K, float dx, float dy, float x_lo,
                                float x_hi, float y_lo, float y_hi, int reach,
                                int periodic, float lx, float inv_lx, int ty,
                                int tx, int cap, cudaStream_t stream) {
    if (ny < 1 || nx < 1 || !plan_ok(K, ty, tx, cap))
        return static_cast<int>(cudaErrorInvalidValue);
    const AdvectArgs a{x,     y,  valid, dt,   out_x, out_y, ny,
                       nx,    K,  ty,    tx,   cap,   reach, dx,
                       dy,    x_lo, x_hi, y_lo, y_hi, lx,   inv_lx,
                       1.0f / dx, 1.0f / dy};
    const int smem = Layout(ty, tx, cap).total;
    const dim3 grid((nx + tx - 1) / tx, (ny + ty - 1) / ty);
    const cudaError_t err =
        periodic ? configure<true>(smem) : configure<false>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (periodic)
        advect_kernel<true><<<grid, NT, smem, stream>>>(a, vx_p, vy_p);
    else
        advect_kernel<false><<<grid, NT, smem, stream>>>(a, vx_p, vy_p);
    return launch_status();
}

// Occupancy of the kernel (periodic: its P form) at tiles of ty x tx
// cells and rounds of cap slots: out as advect_tile.cuh kernel_info's.
PYLAMP_EXPORT int advect_kernel_info(int ty, int tx, int cap, int periodic,
                                     int* out) {
    const void* fn =
        periodic ? reinterpret_cast<const void*>(advect_kernel<true>)
                 : reinterpret_cast<const void*>(advect_kernel<false>);
    return kernel_info(fn, ty, tx, cap, out);
}
