// Per-shard marker re-bucketing from one-ring-extended marker blocks, all
// shards of the in-process mesh in one launch.
//
// Replaces: pylamp_tpu/markers/pallas/rebucket_kernel.py:rebucket_block_pallas.
//
// Bound on the H100: memory.  At FK 1024^2 x K18 on the 4x2 mesh each
// shard reads its (258, 514, 18) extended streams (17 B a slot, 40.6 MB)
// and writes its own (256, 512, 18) buckets (40.1 MB): ~0.65 GB over the 8
// shards, ~0.19 ms at 3.35 TB/s.  No arithmetic to speak of.
//
// Design: one thread per TARGET cell of one shard, the repack of
// rebucket_cell.cuh (kernel 4's, shared).  Markers that crossed a seam
// arrive through the exchanged ring; a source cell (sj, si) sits at
// extended (sj - row_base + 1, si - col_base + 1), and the ring's zero
// fill beyond the domain is invalid.  The candidate order is kernel 4's,
// so the buckets are bit-identical to the single-device repack.  Each
// thread writes only its own bucket: no atomics.
#include "common.cuh"
#include "rebucket_cell.cuh"

namespace {

struct BlockCells {
    long long shard;  // first slot of the shard's extended block
    int row_base, col_base, bx, K;
    __device__ __forceinline__ long long base(int sj, int si) const {
        const int er = sj - row_base + 1, ec = si - col_base + 1;
        return shard + (static_cast<long long>(er) * (bx + 2) + ec) * K;
    }
};

__global__ void rebucket_block_kernel(const float* __restrict__ x,
                                      const float* __restrict__ y,
                                      const float* __restrict__ T,
                                      const int* __restrict__ mat,
                                      const unsigned char* __restrict__ valid,
                                      const int* __restrict__ bases,
                                      float* __restrict__ ox,
                                      float* __restrict__ oy,
                                      float* __restrict__ oT,
                                      int* __restrict__ omat,
                                      unsigned char* __restrict__ ovalid,
                                      int* __restrict__ arrivals_out, int ny,
                                      int nx, int by, int bx, int K, float dx,
                                      float dy) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int r = blockIdx.y * blockDim.y + threadIdx.y;
    const int s = blockIdx.z;
    if (c >= bx || r >= by) return;
    const int row_base = bases[2 * s], col_base = bases[2 * s + 1];
    const BlockCells cells{static_cast<long long>(s) * (by + 2) * (bx + 2) * K,
                           row_base, col_base, bx, K};
    const long long own = (static_cast<long long>(s) * by + r) * bx + c;
    arrivals_out[own] = rebucket_cell(
        cells, x, y, T, mat, valid, ox, oy, oT, omat, ovalid, own * K,
        row_base + r, col_base + c, ny, nx, K, dx, dy);
}

}  // namespace

PYLAMP_EXPORT int launch_rebucket_block(const float* x, const float* y,
                                        const float* T, const int* mat,
                                        const unsigned char* valid,
                                        const int* bases, float* ox,
                                        float* oy, float* oT, int* omat,
                                        unsigned char* ovalid, int* arrivals,
                                        int S, int ny, int nx, int by, int bx,
                                        int K, float dx, float dy,
                                        cudaStream_t stream) {
    dim3 block(32, 4);
    dim3 grid((bx + block.x - 1) / block.x, (by + block.y - 1) / block.y, S);
    rebucket_block_kernel<<<grid, block, 0, stream>>>(
        x, y, T, mat, valid, bases, ox, oy, oT, omat, ovalid, arrivals, ny,
        nx, by, bx, K, dx, dy);
    return launch_status();
}
