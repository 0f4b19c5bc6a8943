// Per-shard RK4 marker advection on the exchanged velocity windows, all
// shards of the in-process mesh in one launch.
//
// Replaces: pylamp_tpu/markers/pallas/advect_kernel.py:advect_block_pallas.
//
// Bound on the H100: memory.  At FK 1024^2 x K18 on the 4x2 mesh each
// shard reads its own (256, 512, 18) x, y (f32) and valid (u8) -- 21 MB --
// and writes the new x, y (19 MB): ~0.32 GB over the 8 shards, ~0.1 ms at
// 3.35 TB/s; ~200 flops per marker.
//
// Design: one thread per marker slot of one shard, the RK4 of
// advect_rk4.cuh (kernel 3's, shared).  The windows are the global
// ghost-padded lattices vx_p / vy_p cut around the shard: window row q,
// column l hold padded node (row_base + q - reach, col_base + l - reach),
// so the lattices below read them through that offset while clamping at
// the global extent; the shift-window mask keeps every read inside the
// window.  dt is read from device memory (no host sync).
#include "common.cuh"
#include "advect_rk4.cuh"

namespace {

__global__ void advect_block_kernel(const float* __restrict__ x,
                                    const float* __restrict__ y,
                                    const unsigned char* __restrict__ valid,
                                    const float* __restrict__ vx_ext,
                                    const float* __restrict__ vy_ext,
                                    const int* __restrict__ bases,
                                    const float* __restrict__ dt_ptr,
                                    float* __restrict__ out_x,
                                    float* __restrict__ out_y, int ny, int nx,
                                    int by, int bx, int K, long long n,
                                    float dx, float dy, float x_lo,
                                    float x_hi, float y_lo, float y_hi,
                                    int reach) {
    const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    if (q >= n) return;
    const long long per_shard = static_cast<long long>(by) * bx * K;
    const int s = static_cast<int>(q / per_shard);
    const long long cell = (q % per_shard) / K;
    const int row_base = bases[2 * s], col_base = bases[2 * s + 1];
    const int cj = row_base + static_cast<int>(cell / bx);
    const int ci = col_base + static_cast<int>(cell % bx);
    const int wr = by + 2 * reach + 1, wc = bx + 2 * reach + 1;
    const long long w = static_cast<long long>(s) * wr * wc;
    const Lattice vxl{vx_ext + w, ny + 2, nx + 1, row_base - reach,
                      col_base - reach, wc};
    const Lattice vyl{vy_ext + w, ny + 1, nx + 2, row_base - reach,
                      col_base - reach, wc};
    rk4_marker(x[q], y[q], valid[q] != 0, cj, ci, *dt_ptr, vxl, vyl, dx, dy,
               1.0f / dx, 1.0f / dy, x_lo, x_hi, y_lo, y_hi, reach, out_x[q],
               out_y[q]);
}

}  // namespace

PYLAMP_EXPORT int launch_advect_block(const float* x, const float* y,
                                      const unsigned char* valid,
                                      const float* vx_ext,
                                      const float* vy_ext, const int* bases,
                                      const float* dt, float* out_x,
                                      float* out_y, int S, int ny, int nx,
                                      int by, int bx, int K, float dx,
                                      float dy, float x_lo, float x_hi,
                                      float y_lo, float y_hi, int reach,
                                      cudaStream_t stream) {
    const long long n = static_cast<long long>(S) * by * bx * K;
    const int threads = 256;
    const unsigned int blocks =
        static_cast<unsigned int>((n + threads - 1) / threads);
    advect_block_kernel<<<blocks, threads, 0, stream>>>(
        x, y, valid, vx_ext, vy_ext, bases, dt, out_x, out_y, ny, nx, by, bx,
        K, n, dx, dy, x_lo, x_hi, y_lo, y_hi, reach);
    return launch_status();
}
