// Per-shard fused marker -> grid transfer from one-ring-extended marker
// blocks, all shards of the in-process mesh in one launch.
//
// Replaces: pylamp_tpu/markers/pallas/m2g_kernel.py:m2g_fused_block_pallas.
//
// Bound on the H100: memory.  At FK 1024^2 x K18 on the 4x2 mesh each
// shard reads its (258, 514, 18) extended streams (x, y, T f32, mat i32,
// valid u8: 17 B a slot, 40.6 MB) and writes 9 planes of 257 x 513
// floats (4.7 MB): ~0.36 GB over the 8 shards, ~0.11 ms at 3.35 TB/s.
//
// Design: kernel 2's row-streamed gather (m2g_rows.cuh, the one body of
// kernels 2 and 10) on every shard.  A block owns a strip of tx node
// columns over a chunk of node rows of one shard's (by + 1) x (bx + 1)
// node frame (markers/kernels/m2g.py m2g_plan on (by, bx): strips of 32
// columns, chunks of 32 rows and two 9-slot units a cell row at 256x512 x
// K18, 17 x 9 x 8 = 1,224 blocks of 192 threads, 4 resident per SM).
//   - Block order, the narrow strip last: the frame's 513th column makes
//     a one-column strip per chunk, whose units cost about a full block's
//     latency.  With blocks in (strip, chunk, shard) order 1,024 full and
//     64 narrow blocks need a third round of the 528 resident slots; the
//     grid is (chunk, shard, strip), so every shard's last strip goes out
//     last and runs in the 32 slots that the full blocks leave free in
//     their second round.
//   - Cells: global cell (r, col), in row_base - 1 .. row_base + by and
//     col_base - 1 .. col_base + bx (the ring), is extended cell (r -
//     row_base + 1, col - col_base + 1) of the shard, row stride (bx + 2)
//     K slots.  The block's cell rows and columns are clamped to the ring
//     and to the domain: beyond the domain the ring is zero-filled
//     (invalid slots), and skipping those cells keeps kernel 2's order.
//   - With the neighbours' markers exchanged into the ring, every node a
//     shard keeps (its own rows and columns and the +1 seam strips) gets
//     every cell that can reach it, in kernel 2's order (cell rows, units,
//     cell columns, slots ascending per half, one shuffle), so its sums
//     are kernel 2's bit for bit.  The frame's last row and column on a
//     shard that is not last on its mesh axis complete at the ring's last
//     cell row or column: partial sums (their third cell lies beyond the
//     ring), which the caller does not use.
//   - Output: every stream in the (S, by + 1, bx + 1) frame; entries of
//     nodes the global lattice lacks (no center, vy or vx node) are 0.
//     One writer per node, a fixed order, no atomics.
//   - The rho0 * alpha corner stream (flag WITH_RA, with the energy
//     streams) is the RA instantiation of the same body.
//   - Periodic side walls (flag PERIODIC; kernel 10p, port-only: the
//     reference keeps its block kernels off under periodic walls) run the
//     body's P form: the ring is exchanged across the x seam, so a seam
//     shard's ring column holds global column nx - 1 (or 0); the block's
//     cell columns are the ring's, unclamped and addressed unwrapped in the
//     extended block, and a marker's x interval is unclamped and counted
//     from the column its cell wraps to, kernel 2p's arithmetic.  So
//     every node a shard keeps gets kernel 2p's sums bit for bit; the
//     frame's last column is partial on every shard (its third cell
//     column, nx + 1, lies beyond the ring), and the caller takes the
//     seam column nx from column 0's owner, as kernel 2p writes column
//     0's sums into both seam columns.  It holds 3 blocks per SM, not 4:
//     its registers (92) do not fit 4 without spilling.
#include "common.cuh"
#include "m2g_rows.cuh"

namespace {

using namespace m2g_rows;

// a shard's (by + 2, bx + 2, K) extended block: global cell (r, col) at
// extended (r - r0, col - c0), r0 = row_base - 1, c0 = col_base - 1, the
// block's first cell at base (the launcher keeps S (by + 2) (bx + 2) K
// below 2^31); P: col unwrapped, the ring's -1 or nx at the seam
struct ShardCells {
    int base, r0, c0, ld, K;
    __device__ __forceinline__ int first(int r, int col) const {
        return (base + (r - r0) * ld + (col - c0)) * K;
    }
};

// a shard's (by + 1, bx + 1) node frame: global node (J, I) at
// base + (J - row_base) ld + I - col_base of every plane
struct FrameOut {
    long long base;
    int row_base, col_base, ld;

    __device__ __forceinline__ long long at(int J, int I) const {
        return base + static_cast<long long>(J - row_base) * ld +
               (I - col_base);
    }

    template <bool P, bool RA>
    __device__ __forceinline__ void put(const M2GArgs& a, int J, int I,
                                        const Sums& acc, bool has_n,
                                        bool has_vy, bool has_vx) const {
        float* const* p = a.out.p;
        const long long o = at(J, I);
        p[C_W][o] = acc.c_w;
        p[C_ETA][o] = acc.c_eta;
        p[N_W][o] = has_n ? acc.n_w : 0.0f;
        p[N_ETA][o] = has_n ? acc.n_eta : 0.0f;
        p[VY_W][o] = has_vy ? acc.vy_w : 0.0f;
        p[VY_RHO][o] = has_vy ? acc.vy_rho : 0.0f;
        if (a.flags & WITH_VX) {
            p[VX_W][o] = has_vx ? acc.vx_w : 0.0f;
            p[VX_RHO][o] = has_vx ? acc.vx_rho : 0.0f;
        }
        if (a.flags & WITH_ENERGY) {
            p[C_T][o] = acc.c_T;
            p[C_K][o] = acc.c_k;
            p[C_RHOCP][o] = acc.c_rhocp;
            if (a.flags & WITH_H) p[C_H][o] = acc.c_H;
            if (RA) p[C_RA][o] = acc.c_ra;
        }
    }
};

// 4 blocks of 6 warps per SM as kernel 2 (at most 80 registers); the P
// form 3 (at most 112: at 80 it spills, ptxas wants 92)
template <bool P, bool RA>
__global__ void __launch_bounds__(MAX_THREADS, P ? 3 : 4)
m2g_block_kernel(const M2GArgs a, const M2GTable tbl_in,
                 const int* __restrict__ bases, int by, int bx) {
    // blockIdx: (chunk, shard, strip), so the last strip comes last
    const int s = blockIdx.y;
    const int row_base = bases[2 * s], col_base = bases[2 * s + 1];
    const int c0 = blockIdx.z * a.tx, r0 = blockIdx.x * a.rows;
    const int cols = min(a.tx, bx + 1 - c0);
    const int rows = min(a.rows, by + 1 - r0);
    const FrameOut out{static_cast<long long>(s) * (by + 1) * (bx + 1),
                       row_base, col_base, bx + 1};
    const int i0 = col_base + c0, j_lo = row_base + r0;
    // frame nodes beyond the global lattice are 0 (none where the shards'
    // blocks tile the grid)
    if (j_lo + rows > a.ny + 1 || i0 + cols > a.nx + 1) {
        for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
            const int J = j_lo + e / cols, I = i0 + e % cols;
            if (J <= a.ny && I <= a.nx) continue;
            for (int n = 0; n < N_OUT; ++n)
                if (a.out.p[n] != nullptr) a.out.p[n][out.at(J, I)] = 0.0f;
        }
    }
    // the ring's cell columns (P: unclamped, wrapped where read)
    const Block b{i0, min(cols, a.nx + 1 - i0), j_lo,
                  min(j_lo + rows, a.ny + 1), max(row_base - 1, 0),
                  min(row_base + by, a.ny - 1),
                  P ? col_base - 1 : max(col_base - 1, 0),
                  P ? col_base + bx : min(col_base + bx, a.nx - 1)};
    if (b.txe < 1 || b.j_lo >= b.j_hi) return;  // (the whole block)
    const ShardCells cells{s * (by + 2) * (bx + 2), row_base - 1,
                           col_base - 1, bx + 2, a.K};
    gather_rows<P, RA>(a, tbl_in, cells, out, b);
}

using KernelFn = void (*)(const M2GArgs, const M2GTable, const int*, int,
                          int);

KernelFn pick(int flags) {
    // RA only with the energy streams, as the wrapper sets it
    const bool ra = (flags & WITH_RA) && (flags & WITH_ENERGY);
    return (flags & PERIODIC) ? (ra ? m2g_block_kernel<true, true>
                                    : m2g_block_kernel<true, false>)
                              : (ra ? m2g_block_kernel<false, true>
                                    : m2g_block_kernel<false, false>);
}

}  // namespace

// bases: (S, 2) int32 on the device, each shard's first own cell (row,
// col); outs: the 13 planes (S, by + 1, bx + 1) or null.  tx, rows, kc,
// nchunks, split: the plan of markers/kernels/m2g.py m2g_plan(by, bx, K).
PYLAMP_EXPORT int launch_m2g_block(const float* x, const float* y,
                                   const float* T, const int* mat,
                                   const unsigned char* valid,
                                   const int* bases, const void* table,
                                   const void* outs, int S, int ny, int nx,
                                   int by, int bx, int K, float dx, float dy,
                                   int flags, int tx, int rows, int kc,
                                   int nchunks, int split,
                                   cudaStream_t stream) {
    if (S < 1 || ny < 1 || nx < 1 || by < 1 || bx < 1 || K < 1 ||
        rows < 1 || !plan_ok(tx, kc, split) || kc * nchunks < K ||
        kc * (nchunks - 1) >= K ||
        static_cast<long long>(S) * (by + 2) * (bx + 2) * K >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    M2GArgs a{x,  y,  T,  mat, valid, {}, ny, nx, K, tx, rows, kc, nchunks,
              split, flags, dx, dy, 1.0f / dx, 1.0f / dy};
    for (int n = 0; n < N_OUT; ++n)
        a.out.p[n] = static_cast<float* const*>(outs)[n];
    const M2GTable tbl = *static_cast<const M2GTable*>(table);
    // (chunk, shard, strip): blocks go out x fastest, so the last strip
    // of every shard (one node column at the mesh's blocks) goes last
    const dim3 grid((by + rows) / rows, S, (bx + tx) / tx);
    const int smem = Layout(tx, kc).total;
    const KernelFn kernel = pick(flags);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, 3 * tx * split, smem, stream>>>(a, tbl, bases, by, bx);
    return launch_status();
}

// Occupancy of the instantiation that `flags` picks (PERIODIC, WITH_RA with
// WITH_ENERGY) at strips of tx columns and units of kc slots: out as
// m2g_rows.cuh kernel_info's.
PYLAMP_EXPORT int m2g_block_kernel_info(int tx, int kc, int split, int flags,
                                        int* out) {
    return kernel_info(reinterpret_cast<const void*>(pick(flags)), tx, kc,
                       split, out);
}
