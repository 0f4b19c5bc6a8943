// Fused multi-iteration Chebyshev momentum smoother: `iters` coupled
// Chebyshev iterations of D^-1 A over [lam/4, lam] in one launch, and
// optionally the residual (rx - A ex', ry - A ey') of the final iterate.
//
// Replaces: pylamp_tpu/ops/pallas/cheb_kernel.py:chebyshev_smooth_pallas
// (with prep_smoother_eta), including the vy wall row ny that the TPU
// wrapper updated outside its kernel.
//
// Bound on the H100: bytes, at ~0.01 ms for 1024^2 (ex, ey, rx, ry,
// eta_s, eta_n read once, ex', ey' and the residual written once).  What
// holds a fused sweep back in practice is issue rate and latency: every
// point is applied `iters` (+1) times from shared memory, on a loaded
// region 1.3-2.6x the tile it writes.
//
// Design: the tile sweep of cheb_tile.cuh (2-D temporal blocking, per-depth
// instantiations, fixed point ownership, a double-buffered iterate, the
// branch-free form for interior tiles, SweepConsts arithmetic, the
// periodic form P), pointed at the level's global arrays.  The tile plan
// comes from the wrapper (ops/kernels/cheb.py tile_plan): the tile height
// (32, 16 or 8 rows) is chosen per level so that the small levels (256^2;
// 512x128, 256x64) spread over more SMs, and the +1 point row and column
// fold into the last tile row and column.
#include "common.cuh"
#include "cheb_tile.cuh"

namespace {

using namespace cheb_tile;

struct SweepArgs {
    TileIO io;
    SweepCtl ctl;
    int ty, nty, ntx;  // tile plan: tile rows, tiles down and across
};

template <int HE, bool P>
__global__ void __launch_bounds__(NT, 1)
cheb_kernel(SweepArgs a, SweepConsts c, const float* __restrict__ kbp) {
    extern __shared__ float smem[];
    const int by = blockIdx.y, bx = blockIdx.x;
    const int cj0 = by * a.ty, ci0 = bx * TX;
    // the last tile row / column also takes the +1 point row / column
    const int TYc = tile_extent(by, a.nty, a.ty, c.ny + 1);
    const int TXc = tile_extent(bx, a.ntx, TX, c.nx + 1);
    sweep_tile<HE, P>(a.io, a.ctl, c, __ldg(kbp), smem, cj0, ci0, TYc, TXc);
}

// the instantiation for depth HE (P: periodic side walls)
template <int HE, bool P>
int launch_he(const SweepArgs& a, const SweepConsts& c, const float* kb,
              cudaStream_t stream) {
    if (!fits<HE>(a.ty)) return static_cast<int>(cudaErrorInvalidValue);
    // the tallest tile's planes, set once
    static const cudaError_t attr = cudaFuncSetAttribute(
        cheb_kernel<HE, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<HE>(TX)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    cheb_kernel<HE, P><<<dim3(a.ntx, a.nty), NT, smem_bytes<HE>(a.ty),
                         stream>>>(a, c, kb);
    return launch_status();
}

}  // namespace

PYLAMP_EXPORT int launch_cheb(const float* ex, const float* ey,
                              const float* rx, const float* ry,
                              const float* eta_s, const float* eta_n,
                              const float* coeffs, const float* kb,
                              float* ox, float* oy, float* fx, float* fy,
                              int ny, int nx, float dx, float dy,
                              float s_top, float s_bottom, float s_left,
                              float s_right, int iters, int h, int zero_init,
                              int emit, int ty, int periodic,
                              cudaStream_t stream) {
    const int he = iters + (emit ? 1 : 0);
    if (iters < 1 || he > h || he > MAX_HE || ty < 1 || ty > TX || ny < 1
        || nx < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const SweepConsts c = sweep_consts(ny, nx, dx, dy, s_top, s_bottom,
                                       s_left, s_right);
    const SweepArgs a{{ex, ey, rx, ry, eta_s, eta_n, ox, oy, fx, fy, nx + 1,
                       nx, nx + 1, nx},
                      {coeffs, iters, zero_init, emit},
                      ty, (ny + ty - 1) / ty, (nx + TX - 1) / TX};
    return with_depth(he, [&](auto d) {
        constexpr int HE = decltype(d)::value;
        return periodic ? launch_he<HE, true>(a, c, kb, stream)
                        : launch_he<HE, false>(a, c, kb, stream);
    });
}

// Occupancy of the depth-he instantiation (periodic: its periodic form)
// with tiles of ty rows: out = {registers per thread, static shared bytes,
// local (spill) bytes per thread, resident blocks per SM, threads per
// block, dynamic shared bytes}.
PYLAMP_EXPORT int cheb_kernel_info(int he, int ty, int periodic, int* out) {
    return with_depth(he, [&](auto d) {
        constexpr int HE = decltype(d)::value;
        const void* fn =
            periodic ? reinterpret_cast<const void*>(cheb_kernel<HE, true>)
                     : reinterpret_cast<const void*>(cheb_kernel<HE, false>);
        return kernel_info(fn, smem_bytes<HE>(TX), smem_bytes<HE>(ty), out);
    });
}
