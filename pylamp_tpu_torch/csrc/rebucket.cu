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
// Design: one thread per TARGET cell.  It walks the 3x3 source cells in
// exactly the reference's insertion order — a in (-1, 0, 1), then b in
// (-1, 0, 1), then slot s ascending — takes every valid marker whose owning
// cell clip((int)(x / dx)) is this cell, inserts it at `count` while
// count < K, and counts every arrival for the overflow drop count.  Each
// thread writes only its own bucket, so there are no atomics and the
// result is deterministic and identical slot for slot to the plain
// version.  The owning cell uses IEEE f32 division by the f32 cell size,
// as the reference traces it (this file must not be built with
// --use_fast_math).  The neighbourhood reads of a warp overlap and are
// served from L1/L2, so device memory sees each source bucket about once.
#include "common.cuh"

namespace {

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
    int count = 0;
    int arrivals = 0;
    for (int a = -1; a <= 1; ++a) {
        const int sj = cj + a;
        if (sj < 0 || sj >= ny) continue;
        for (int b = -1; b <= 1; ++b) {
            const int si = ci + b;
            if (si < 0 || si >= nx) continue;
            const long long in_base = (static_cast<long long>(sj) * nx + si) * K;
            for (int s = 0; s < K; ++s) {
                const long long q = in_base + s;
                if (!valid[q]) continue;
                const float px = x[q];
                const float py = y[q];
                const int ti = min(max(static_cast<int>(px / dx), 0), nx - 1);
                const int tj = min(max(static_cast<int>(py / dy), 0), ny - 1);
                if (ti != ci || tj != cj) continue;
                ++arrivals;
                if (count < K) {
                    const long long o = out_base + count;
                    ox[o] = px;
                    oy[o] = py;
                    oT[o] = T[q];
                    omat[o] = mat[q];
                    ovalid[o] = 1;
                    ++count;
                }
            }
        }
    }
    for (int s = count; s < K; ++s) {
        const long long o = out_base + s;
        ox[o] = 0.0f;
        oy[o] = 0.0f;
        oT[o] = 0.0f;
        omat[o] = 0;
        ovalid[o] = 0;
    }
    arrivals_out[cj * nx + ci] = arrivals;
}

}  // namespace

PYLAMP_EXPORT int launch_rebucket(const float* x, const float* y,
                                  const float* T, const int* mat,
                                  const unsigned char* valid, float* ox,
                                  float* oy, float* oT, int* omat,
                                  unsigned char* ovalid, int* arrivals,
                                  int ny, int nx, int K, float dx, float dy,
                                  cudaStream_t stream) {
    dim3 block(32, 4);
    rebucket_kernel<<<grid2d(ny, nx, block), block, 0, stream>>>(
        x, y, T, mat, valid, ox, oy, oT, omat, ovalid, arrivals, ny, nx, K,
        dx, dy);
    return launch_status();
}
