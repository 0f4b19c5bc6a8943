// Per-shard marker re-bucketing from one-ring-extended marker blocks, all
// shards of the in-process mesh in one launch.
//
// Replaces: pylamp_tpu/markers/pallas/rebucket_kernel.py:rebucket_block_pallas.
//
// Bound on the H100: memory.  At FK 1024^2 x K18 on the 4x2 mesh each
// shard reads its (258, 514, 18) extended streams (17 B a slot, 40.6 MB)
// and writes its own (256, 512, 18) buckets (40.1 MB) and arrivals: ~0.65
// GB over the 8 shards, ~0.19 ms at 3.35 TB/s.  No arithmetic to speak of.
//
// Design: kernel 4's row-streamed repack (rebucket_rows.cuh, the one body
// of kernels 4 and 12) on every shard, blockIdx.z the shard.  A block owns
// a strip of tx target columns over a chunk of target rows of one shard's
// by x bx block (markers/kernels/rebucket.py rebucket_plan on (by, bx):
// strips of 32 columns and chunks of 32 rows at 256x512 x K18, 16 x 8 x 8
// = 1,024 blocks), walks its rows with a ring of 4 source rows loaded by
// cp.async, codes each slot's target once per ring row, places it by popc
// of the cells' target masks in the reference's order and stores each
// output row contiguously.
//   - Source rows: global row sj, in row_base - 1 .. row_base + by, is
//     extended row sj - row_base + 1 of the shard, row stride (bx + 2) K
//     slots; the strip's halo columns always lie in the extended block
//     (the exchanged ring), and beyond the domain the strip has none (as
//     kernel 4: those columns are zero-filled, so invalid, anyway).
//   - The one-byte valid stream is loaded as the aligned words that hold
//     a run; the lead of each run comes from the run's own address in the
//     extended block.
//   - Codes use the global cell (sj, si) and the global clip to (ny, nx),
//     so the buckets are bit-identical to the single-device repack.
//   - Output row cj of the shard lands at ((s by + cj - row_base) bx +
//     col - col_base) K; each target's arrivals (the reference's count
//     output) go to (S, by, bx) int32, from which the caller sums the
//     drops.  The block writes only its own cells: no atomics.
//   - Periodic side walls (kernel 12p, the P instantiation; port-only:
//     the reference keeps its block kernels off under periodic walls):
//     the ring is exchanged across the x seam, so a seam strip's halo
//     column is global column nx - 1 (or 0), which the source CellMap maps
//     back into the ring; its slots are coded against that wrapped column
//     with kernel 4p's wrapped offset.  A marker that kernel 11p wrote
//     past the seam is thus taken by the cell its x names on the far
//     shard, in kernel 4p's candidate order, and by no other shard: the
//     slot assignment is kernel 4p's.
#include "common.cuh"
#include "rebucket_rows.cuh"

namespace {

using namespace rebucket_rows;

template <bool P>
__global__ void __launch_bounds__(NT, 3)
rebucket_block_kernel(const RebucketArgs a, const int* __restrict__ bases,
                      int by, int bx) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int s = blockIdx.z;
    const int row_base = bases[2 * s], col_base = bases[2 * s + 1];
    const int c0 = blockIdx.x * a.tx, r0 = blockIdx.y * a.rows;
    // the shard's extended block starts at global (row_base - 1,
    // col_base - 1), its own block at (row_base, col_base)
    const int we = bx + 2;
    const CellMap src{static_cast<long long>(s) * (by + 2) * we
                          - static_cast<long long>(row_base - 1) * we
                          - (col_base - 1),
                      we, col_base - 1, P ? a.nx : 0};
    const CellMap dst{static_cast<long long>(s) * by * bx
                          - static_cast<long long>(row_base) * bx - col_base,
                      bx};
    const Block b{src, dst, col_base + c0, min(a.tx, bx - c0),
                  row_base + r0, row_base + min(r0 + a.rows, by)};
    repack<P, true>(a, b, smem);
}

using KernelFn = void (*)(const RebucketArgs, const int*, int, int);

KernelFn pick(int periodic) {
    return periodic ? rebucket_block_kernel<true>
                    : rebucket_block_kernel<false>;
}

}  // namespace

// bases: (S, 2) int32 on the device, each shard's first own cell (row,
// col); arrivals: (S, by, bx) int32.  tx, rows: the strip width and chunk
// rows of rebucket_plan(by, bx, K); periodic: the P form.
PYLAMP_EXPORT int launch_rebucket_block(const float* x, const float* y,
                                        const float* T, const int* mat,
                                        const unsigned char* valid,
                                        const int* bases, float* ox,
                                        float* oy, float* oT, int* omat,
                                        unsigned char* ovalid, int* arrivals,
                                        int S, int ny, int nx, int by, int bx,
                                        int K, float dx, float dy, int tx,
                                        int rows, int periodic,
                                        cudaStream_t stream) {
    if (S < 1 || by < 1 || bx < 1 || K < 1 || tx < 1 || rows < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = Layout(tx, K).total;
    const RebucketArgs a{x, y, T, mat, valid, ox, oy, oT, omat, ovalid,
                         nullptr, arrivals, ny, nx, K, tx, rows, dx, dy};
    const KernelFn kernel = pick(periodic);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((bx + tx - 1) / tx, (by + rows - 1) / rows, S);
    kernel<<<grid, NT, smem, stream>>>(a, bases, by, bx);
    return launch_status();
}

// Occupancy of the kernel (periodic: its P form) at strips of tx columns
// and K slots: out as rebucket_kernel_info's.
PYLAMP_EXPORT int rebucket_block_kernel_info(int K, int tx, int periodic,
                                             int* out) {
    return kernel_info(reinterpret_cast<const void*>(pick(periodic)),
                       Layout(tx, K).total, out);
}
