// Marker re-bucketing: repack every (ny, nx, K) cell bucket from its 3x3
// neighbourhood after advection.
//
// Replaces: pylamp_tpu/markers/pallas/rebucket_kernel.py:rebucket_pallas.
//
// Bound on the H100: memory.  At 1024^2 x K18 (18.9 M slots) it reads the
// five marker streams (x, y, T f32, mat i32, valid u8: 17 B a slot, 321 MB)
// and writes them once more (321 MB): ~0.64 GB, ~0.2 ms at 3.35 TB/s.
// There is no arithmetic to speak of; what a repack costs beyond the bytes
// is instructions per slot, which the design keeps few.
//
// Design: a row-streamed repack in shared memory.  The layout stays
// (ny, nx, K), which every other marker kernel shares.
//   - A block owns a strip of TX target columns over a chunk of ROWS
//     target rows (markers/kernels/rebucket.py rebucket_plan: TX = 32 and
//     ROWS = 32 at K = 18, 32 x 32 blocks at 1024^2).  It walks its rows
//     top to bottom with a ring of RING = 4 source rows in shared memory;
//     a ring row holds the (TX + 2) * K slots of x, y, T and mat of the
//     strip and its two halo columns.  A row of cells is one contiguous
//     run of K-slot buckets, so the loads are coalesced: cp.async of 4
//     bytes a thread, and for the one-byte valid stream an aligned
//     superset of words.  Row r + 2 is in flight while row r is repacked.
//     Device memory sees each source slot (TX + 2) / TX times, plus two
//     halo rows per chunk.
//   - Once per ring row, each slot's owning cell is computed as the plain
//     version computes it (IEEE f32 x / dx, truncation, clip; no fast
//     math), i.e. the 3x3 target it moves to or none, kept as a one-byte
//     code in place of its valid byte, and the slot's bit is set in its
//     cell's mask for that target (9 masks of ceil(K / 32) words per
//     cell, a shared-memory atomicOr).
//   - Insertion in the reference's order (a in (-1, 0, 1), then b in
//     (-1, 0, 1), then the slots ascending) follows from the masks:
//     target cell T takes its sources S = T + (a, b) in the order
//     k = 3 (a + 1) + b + 1, so a slot's place in T is the number of
//     slots T's earlier sources send it (popc of their masks) plus the
//     slot's rank in its own cell's mask (popc of the lower bits).  One
//     thread per target forms that prefix over its sources in rows r - 1
//     and r while row r + 1 is coded, and the arrivals (for the drops)
//     after; then every source slot bound for row r is scattered once to
//     its place in the output row in shared memory while that is below K.
//     The reference's walk of 9 K candidates per target becomes one look
//     at each slot per target row, every pass runs over the slots flat, a
//     lane per slot, and a row takes three barriers.  Few markers change
//     rows in a step, so each ring row counts its slots bound up and down,
//     and a neighbour row with none bound for row r is not scanned.
//   - The output row (TX * K slots of each stream) is written once with
//     contiguous stores; the slots past a bucket's count come out as 0
//     (valid 0), as in the plain version.
//   - Each block sums its overflow drops (arrivals - K where positive) and
//     adds them to the 64-bit drop count with one integer atomic: the sum
//     does not depend on the order, so a launch is deterministic.
// Periodic side walls: the P instantiation, whose halo columns wrap (a
// strip at the seam loads its halo column from the opposite edge), and
// whose column offset is the reference's wrapped one, (ti - si + 1) mod
// nx - 1 (nx >= 3, checked by the wrapper).  Both forms are identical
// slot for slot to the plain version, with the same drop count.
// The body (rebucket_rows.cuh) is shared with the per-shard rebucket
// (kernel 12, rebucket_block.cu), which runs it on every shard's
// extended marker blocks.
#include "common.cuh"
#include "rebucket_rows.cuh"

namespace {

using namespace rebucket_rows;

template <bool P>
__global__ void __launch_bounds__(NT, 3)
rebucket_kernel(const RebucketArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int i0 = blockIdx.x * a.tx, j_lo = blockIdx.y * a.rows;
    const CellMap cells{0, a.nx};
    const Block b{cells, cells, i0, min(a.tx, a.nx - i0), j_lo,
                  min(j_lo + a.rows, a.ny)};
    repack<P, false>(a, b, smem);
}

template <bool P>
cudaError_t configure(int smem) {
    return cudaFuncSetAttribute(rebucket_kernel<P>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
}

}  // namespace

// dropped: one int64 on the device, zeroed by the caller; the launch adds
// this call's overflow drops to it.  tx, rows: the strip width and chunk
// rows of rebucket_plan.
PYLAMP_EXPORT int launch_rebucket(const float* x, const float* y,
                                  const float* T, const int* mat,
                                  const unsigned char* valid, float* ox,
                                  float* oy, float* oT, int* omat,
                                  unsigned char* ovalid, long long* dropped,
                                  int ny, int nx, int K, float dx, float dy,
                                  int tx, int rows, int periodic,
                                  cudaStream_t stream) {
    if (ny < 1 || nx < 1 || K < 1 || tx < 1 || rows < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = Layout(tx, K).total;
    const RebucketArgs a{x, y, T, mat, valid, ox, oy, oT, omat, ovalid,
                         reinterpret_cast<unsigned long long*>(dropped),
                         nullptr, ny, nx, K, tx, rows, dx, dy};
    const dim3 grid((nx + tx - 1) / tx, (ny + rows - 1) / rows);
    cudaError_t err =
        periodic ? configure<true>(smem) : configure<false>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (periodic)
        rebucket_kernel<true><<<grid, NT, smem, stream>>>(a);
    else
        rebucket_kernel<false><<<grid, NT, smem, stream>>>(a);
    return launch_status();
}

// Occupancy of the kernel (periodic: its P form) at strips of tx columns
// and K slots: out = {registers per thread, static shared bytes, local
// (spill) bytes per thread, resident blocks per SM, threads per block,
// dynamic shared bytes}.
PYLAMP_EXPORT int rebucket_kernel_info(int K, int tx, int periodic,
                                       int* out) {
    return kernel_info(
        periodic ? reinterpret_cast<const void*>(rebucket_kernel<true>)
                 : reinterpret_cast<const void*>(rebucket_kernel<false>),
        Layout(tx, K).total, out);
}
