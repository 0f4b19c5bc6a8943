// Fused multi-iteration Chebyshev smoother on the depth-h halo frames of
// every shard of the in-process mesh, in one launch: `iters` coupled
// Chebyshev iterations of D^-1 A and optionally the residual of the final
// iterate, returned on each shard's central (by, bx) block.
//
// Replaces: pylamp_tpu/ops/pallas/cheb_block_kernel.py:cheb_block_pallas.
//
// Bound on the H100: memory.  Per shard at FK 1024^2 on the 4x2 mesh
// (256x512 blocks, h = 5) it reads six frames of ~266 x 522 floats
// (3.3 MB) and writes 2-4 blocks of 256 x 512 (1-2 MB): ~5 MB a shard,
// ~40 MB over the 8 shards, ~12 us at 3.35 TB/s; ~130 flops per point and
// iteration, far below the f32 peak.  As for kernel 5, what holds a fused
// sweep back in practice is issue rate and latency on shared memory.
//
// Design: kernel 5's tile sweep (cheb_tile.cuh), pointed at a shard's
// frame instead of the global arrays: one body for both kernels.
//   - blockIdx.z is the shard; its tiles cover the central by x bx block
//     (ops/kernels/cheb.py block_tile_plan: the tile height per level,
//     with the shards counted in the waves; the last tile row and column
//     take what is left).
//   - The frame is addressed in a per-shard index space in which the
//     shard's PHYSICAL walls sit where the tile sweep expects them (row 0
//     / ny, column 0 / nx) and every other edge lies out of reach: the
//     wall flags (device data, one row per shard, read once per block)
//     choose the origin (0 at a wall, K_OFF beyond the deepest halo
//     elsewhere) and the far walls (by or bx past the origin, or K_FAR).
//     The frame pointers are shifted so that the tile sweep's indices of
//     that space reach the frame, and frames deeper than the sweep are
//     entered at their depth h: the loaded region (the centre and he <= h
//     rings) never leaves the frame, so no bounds test remains.
//   - A tile whose loaded region reaches no physical wall of its shard
//     takes the branch-free form: every tile of an interior shard, and
//     the inner tiles of every shard.  Edge tiles resolve the wall ghosts
//     inline from current values and evolve the Dirichlet lines inside
//     the frame by the pointwise kbnd recurrence, as the reference
//     kernel's runtime-flag selects do; the frame's outer rings are
//     sacrificial.
//   - The sweep is instantiated per depth he = iters (+1 with the
//     residual), with SweepConsts' hoisted reciprocals (the 2e-5 bar of
//     kernel 5's reassociation).  Coefficients and kbnd come from device
//     memory.  No atomics: a launch is deterministic.
#include "common.cuh"
#include "cheb_tile.cuh"

namespace {

using namespace cheb_tile;

// the origin of a shard without a wall on that side: beyond the deepest
// halo, so no loaded point reaches row or column 0
constexpr int K_OFF = MAX_HE + 1;
constexpr int K_FAR = 1 << 29;  // a far wall that is never reached

// the frames of shard 0 (the others follow at the per-shard strides): ex,
// rx (R, C+1), ey, ry (R+1, C), es (R+1, C+1), en (R, C) with R = by + 2h,
// C = bx + 2h; outputs (by, bx)
struct BlockArgs {
    TileIO io;
    SweepCtl ctl;
    const float* flags;  // (S, 4): top, bottom, left, right
    int by, bx, h;
    int ty, nty, ntx;  // tile plan: tile rows, tiles down and across
};

template <int HE>
__global__ void __launch_bounds__(NT, 1)
cheb_block_kernel(BlockArgs a, SweepConsts c, const float* __restrict__ kbp) {
    extern __shared__ float smem[];
    const int s = blockIdx.z;
    const float* fl = a.flags + 4 * s;
    const bool wt = __ldg(fl) > 0.5f, wb = __ldg(fl + 1) > 0.5f;
    const bool wl = __ldg(fl + 2) > 0.5f, wr = __ldg(fl + 3) > 0.5f;
    const int by = a.by, bx = a.bx, h = a.h;
    const int oy0 = wt ? 0 : K_OFF, ox0 = wl ? 0 : K_OFF;
    c.ny = wb ? oy0 + by : K_FAR;
    c.nx = wr ? ox0 + bx : K_FAR;
    // point (gj, gi) of the shard's space is frame (gj - oy0 + h,
    // gi - ox0 + h) and output (gj - oy0, gi - ox0)
    const long long R = by + 2 * h, C = bx + 2 * h;
    const long long sx = s * R * (C + 1) + (h - oy0) * (C + 1) + (h - ox0);
    const long long sy = s * (R + 1) * C + (h - oy0) * C + (h - ox0);
    const long long ss = s * (R + 1) * (C + 1) + (h - oy0) * (C + 1)
                         + (h - ox0);
    const long long sn = s * R * C + (h - oy0) * C + (h - ox0);
    const long long so = static_cast<long long>(s) * by * bx - oy0 * bx - ox0;
    const TileIO io{a.io.ex + sx, a.io.ey + sy, a.io.rx + sx, a.io.ry + sy,
                    a.io.es + ss, a.io.en + sn, a.io.ox + so, a.io.oy + so,
                    a.io.fx + so, a.io.fy + so, static_cast<int>(C + 1),
                    static_cast<int>(C), bx, bx};
    const int bj = blockIdx.y, bi = blockIdx.x;
    const int TYc = tile_extent(bj, a.nty, a.ty, by);
    const int TXc = tile_extent(bi, a.ntx, TX, bx);
    sweep_tile<HE, false>(io, a.ctl, c, __ldg(kbp), smem, oy0 + bj * a.ty,
                          ox0 + bi * TX, TYc, TXc);
}

template <int HE>
int launch_he(const BlockArgs& a, int S, const SweepConsts& c,
              const float* kb, cudaStream_t stream) {
    if (!fits<HE>(a.ty)) return static_cast<int>(cudaErrorInvalidValue);
    // the tallest tile's planes, set once
    static const cudaError_t attr = cudaFuncSetAttribute(
        cheb_block_kernel<HE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<HE>(TX)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    cheb_block_kernel<HE><<<dim3(a.ntx, a.nty, S), NT, smem_bytes<HE>(a.ty),
                            stream>>>(a, c, kb);
    return launch_status();
}

}  // namespace

PYLAMP_EXPORT int launch_cheb_block(const float* ex, const float* ey,
                                    const float* rx, const float* ry,
                                    const float* es, const float* en,
                                    const float* flags, const float* coeffs,
                                    const float* kb, float* ox, float* oy,
                                    float* fx, float* fy, int S, int by,
                                    int bx, int h, float dx, float dy,
                                    float s_top, float s_bottom, float s_left,
                                    float s_right, int iters, int zero_init,
                                    int emit, int ty, cudaStream_t stream) {
    const int he = iters + (emit ? 1 : 0);
    if (iters < 1 || he > h || he > MAX_HE || ty < 1 || ty > TX || S < 1
        || by < 1 || bx < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    // ny, nx: per shard, from its wall flags
    const SweepConsts c = sweep_consts(0, 0, dx, dy, s_top, s_bottom, s_left,
                                       s_right);
    // the +1 point row / column of a level has no counterpart here: the
    // tiles cover by x bx, the last tile row / column what is left
    const BlockArgs a{{ex, ey, rx, ry, es, en, ox, oy, fx, fy, 0, 0, 0, 0},
                      {coeffs, iters, zero_init, emit},
                      flags, by, bx, h,
                      ty, (by - 1 + ty - 1) / ty + (by == 1),
                      (bx - 1 + TX - 1) / TX + (bx == 1)};
    return with_depth(he, [&](auto d) {
        return launch_he<decltype(d)::value>(a, S, c, kb, stream);
    });
}

// Occupancy of the depth-he instantiation with tiles of ty rows: out as
// cheb_kernel_info's.
PYLAMP_EXPORT int cheb_block_kernel_info(int he, int ty, int* out) {
    return with_depth(he, [&](auto d) {
        constexpr int HE = decltype(d)::value;
        return kernel_info(
            reinterpret_cast<const void*>(cheb_block_kernel<HE>),
            smem_bytes<HE>(TX), smem_bytes<HE>(ty), out);
    });
}
