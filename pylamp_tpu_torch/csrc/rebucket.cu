// Marker re-bucketing: repack every (ny, nx, K) cell bucket from its 3x3
// neighbourhood after advection.
//
// Replaces: pylamp_tpu/markers/pallas/rebucket_kernel.py:rebucket_pallas.
//
// Bound on the H100: memory.  At 1024^2 x K18 (18.9 M slots) it reads the
// five marker streams (x, y, T f32, mat i32, valid u8: 17 B a slot, 321 MB)
// and writes them once more (321 MB): ~0.64 GB, ~0.2 ms at 3.35 TB/s.
// There is no arithmetic to speak of.
//
// Design: one thread per TARGET cell, the repack of rebucket_cell.cuh
// (shared with the per-shard rebucket_block.cu): the reference's insertion
// order, so the result is identical slot for slot to the plain version.
// Each thread writes only its own bucket, so there are no atomics.  The
// neighbourhood reads of a warp overlap and are served from L1/L2, so
// device memory sees each source bucket about once.  Periodic side walls:
// the P instantiation, whose source columns wrap (nx >= 3, checked by the
// wrapper); it stays identical slot for slot to the plain version.
#include "common.cuh"
#include "rebucket_cell.cuh"

namespace {

// the (ny, nx, K) bucket layout
struct GlobalCells {
    int nx, K;
    __device__ __forceinline__ long long base(int sj, int si) const {
        return (static_cast<long long>(sj) * nx + si) * K;
    }
};

template <bool P>
__global__ void rebucket_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                const float* __restrict__ T,
                                const int* __restrict__ mat,
                                const unsigned char* __restrict__ valid,
                                float* __restrict__ ox, float* __restrict__ oy,
                                float* __restrict__ oT, int* __restrict__ omat,
                                unsigned char* __restrict__ ovalid,
                                int* __restrict__ arrivals_out, int ny, int nx,
                                int K, float dx, float dy) {
    const int ci = blockIdx.x * blockDim.x + threadIdx.x;
    const int cj = blockIdx.y * blockDim.y + threadIdx.y;
    if (ci >= nx || cj >= ny) return;
    const long long out_base = (static_cast<long long>(cj) * nx + ci) * K;
    arrivals_out[cj * nx + ci] = rebucket_cell<P>(
        GlobalCells{nx, K}, x, y, T, mat, valid, ox, oy, oT, omat, ovalid,
        out_base, cj, ci, ny, nx, K, dx, dy);
}

}  // namespace

PYLAMP_EXPORT int launch_rebucket(const float* x, const float* y,
                                  const float* T, const int* mat,
                                  const unsigned char* valid, float* ox,
                                  float* oy, float* oT, int* omat,
                                  unsigned char* ovalid, int* arrivals,
                                  int ny, int nx, int K, float dx, float dy,
                                  int periodic, cudaStream_t stream) {
    dim3 block(32, 4);
    if (periodic)
        rebucket_kernel<true><<<grid2d(ny, nx, block), block, 0, stream>>>(
            x, y, T, mat, valid, ox, oy, oT, omat, ovalid, arrivals, ny, nx,
            K, dx, dy);
    else
        rebucket_kernel<false><<<grid2d(ny, nx, block), block, 0, stream>>>(
            x, y, T, mat, valid, ox, oy, oT, omat, ovalid, arrivals, ny, nx,
            K, dx, dy);
    return launch_status();
}
