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
// Design: the gather of m2g_node.cuh (kernel 2's, shared), one thread per
// node (row_base + r, col_base + c), r in 0..by, c in 0..bx, of one shard
// (blockIdx.z).  With the neighbours' markers exchanged into the ring,
// every node a shard keeps -- its own rows and columns and the +1 seam
// strips -- gets every cell that can reach it, in kernel 2's order, so
// the sums are kernel 2's.  Output planes are (S, by+1, bx+1) in the
// shard's node frame; entries of nodes the global lattice lacks are 0, and
// center/vx-kind entries on the frame's last row and vy/center-kind ones
// on its last column are partial (their cells lie beyond the ring) and
// unused.  No atomics: one writer per node, a fixed order.  The rho0 *
// alpha corner stream (flag WITH_RA, with the energy streams) is the RA
// instantiation of the shared gather.
#include "common.cuh"
#include "m2g_node.cuh"

namespace {

// cells of one shard's (by+2, bx+2, K) extended block: global cell (cj, ci)
// sits at extended (cj - row_base + 1, ci - col_base + 1)
struct BlockCells {
    long long shard;  // first slot of the shard's block
    int row_base, col_base, by, bx, K;
    __device__ __forceinline__ long long base(int cj, int ci) const {
        const int er = cj - row_base + 1, ec = ci - col_base + 1;
        if (er < 0 || er >= by + 2 || ec < 0 || ec >= bx + 2) return -1;
        return shard + (static_cast<long long>(er) * (bx + 2) + ec) * K;
    }
};

template <bool RA>
__global__ void m2g_block_kernel(const float* __restrict__ x,
                                 const float* __restrict__ y,
                                 const float* __restrict__ T,
                                 const int* __restrict__ mat,
                                 const unsigned char* __restrict__ valid,
                                 const int* __restrict__ bases, M2GTable tbl,
                                 M2GOut out, int ny, int nx, int by, int bx,
                                 int K, float dx, float dy, int flags) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int r = blockIdx.y * blockDim.y + threadIdx.y;
    const int s = blockIdx.z;
    if (c > bx || r > by) return;
    const int row_base = bases[2 * s], col_base = bases[2 * s + 1];
    const int J = row_base + r, I = col_base + c;
    const long long o =
        (static_cast<long long>(s) * (by + 1) + r) * (bx + 1) + c;
    if (J > ny || I > nx) {  // beyond the corner lattice: no node
        for (int n = 0; n < N_OUT; ++n)
            if (out.p[n] != nullptr) out.p[n][o] = 0.0f;
        return;
    }
    const BlockCells cells{
        static_cast<long long>(s) * (by + 2) * (bx + 2) * K, row_base,
        col_base, by, bx, K};
    const NodeSums sums = m2g_gather<false, RA>(cells, x, y, T, mat, valid,
                                                tbl, J, I, ny, nx, K, dx, dy,
                                                flags);
    const bool has[N_OUT] = {true, true, sums.has_n, sums.has_n, sums.has_vy,
                             sums.has_vy, sums.has_vx, sums.has_vx, true,
                             true, true, true, true};
    for (int n = 0; n < N_OUT; ++n)
        if (out.p[n] != nullptr) out.p[n][o] = has[n] ? sums.v[n] : 0.0f;
}

}  // namespace

PYLAMP_EXPORT int launch_m2g_block(const float* x, const float* y,
                                   const float* T, const int* mat,
                                   const unsigned char* valid,
                                   const int* bases, const void* table,
                                   const void* outs, int S, int ny, int nx,
                                   int by, int bx, int K, float dx, float dy,
                                   int flags, cudaStream_t stream) {
    const M2GTable tbl = *static_cast<const M2GTable*>(table);
    M2GOut out;
    for (int n = 0; n < N_OUT; ++n)
        out.p[n] = static_cast<float* const*>(outs)[n];
    dim3 block(32, 4);
    dim3 grid((bx + 1 + block.x - 1) / block.x,
              (by + 1 + block.y - 1) / block.y, S);
    const bool ra = (flags & WITH_RA) && (flags & WITH_ENERGY);
    auto kernel = ra ? m2g_block_kernel<true> : m2g_block_kernel<false>;
    kernel<<<grid, block, 0, stream>>>(x, y, T, mat, valid, bases, tbl, out,
                                       ny, nx, by, bx, K, dx, dy, flags);
    return launch_status();
}
