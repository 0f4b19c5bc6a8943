// Fused RK4 marker advection in the (ny, nx, K) bucket layout.
//
// Replaces: pylamp_tpu/markers/pallas/advect_kernel.py:advect_rk4_pallas.
//
// Bound on the H100: memory.  At 1024^2 x K18 (18.9 M slots) it reads
// x, y (f32) and valid (u8) — 170 MB — and writes the new x, y (151 MB):
// ~0.32 GB, ~0.1 ms at 3.35 TB/s.  The ghost-padded velocity lattices
// (2 x 4.2 MB) stay resident in L2 for the 32 bilinear reads per marker
// (4 stages x 2 lattices x 4 corners); ~200 flops per marker.
//
// Design: one thread per marker slot, the RK4 of advect_rk4.cuh (shared
// with the per-shard advect_block.cu) on the ghost-padded lattices the
// wrapper builds exactly as the reference does.  dt is read from device
// memory (no host sync).  Periodic side walls: the P instantiation, on the
// wrapped velocity planes the wrapper builds (each padded by PADW columns
// on both sides, as the TPU wrapper builds its wrapped column planes);
// the sampled x is not clamped and the new x wraps into [0, lx).  The
// reads and writes are those of the wall form.
#include "common.cuh"
#include "advect_rk4.cuh"

namespace {

// columns of wrap padding on each side of a periodic plane (>= the
// largest stage reach + 1); markers/kernels/advect.py PADW
constexpr int PADW = 3;

template <bool P>
__global__ void advect_kernel(const float* __restrict__ x,
                              const float* __restrict__ y,
                              const unsigned char* __restrict__ valid,
                              Lattice vxl, Lattice vyl,
                              const float* __restrict__ dt_ptr,
                              float* __restrict__ out_x,
                              float* __restrict__ out_y, int nx, int K,
                              long long n, float dx, float dy, float x_lo,
                              float x_hi, float y_lo, float y_hi, int reach,
                              float lx, float inv_lx) {
    const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    if (q >= n) return;
    const long long cell = q / K;
    const int cj = static_cast<int>(cell / nx);
    const int ci = static_cast<int>(cell % nx);
    rk4_marker<P>(x[q], y[q], valid[q] != 0, cj, ci, *dt_ptr, vxl, vyl, dx,
                  dy, x_lo, x_hi, y_lo, y_hi, reach, out_x[q], out_y[q], lx,
                  inv_lx);
}

}  // namespace

PYLAMP_EXPORT int launch_advect(const float* x, const float* y,
                                const unsigned char* valid, const float* vx_p,
                                const float* vy_p, const float* dt,
                                float* out_x, float* out_y, int ny, int nx,
                                int K, float dx, float dy, float x_lo,
                                float x_hi, float y_lo, float y_hi, int reach,
                                int periodic, float lx, float inv_lx,
                                cudaStream_t stream) {
    const long long n = static_cast<long long>(ny) * nx * K;
    const int threads = 256;
    const unsigned int blocks =
        static_cast<unsigned int>((n + threads - 1) / threads);
    if (periodic) {
        // planes (ny + 2 | ny + 1, nx + 2 PADW), column c at c + PADW
        const int w = nx + 2 * PADW;
        const Lattice vxl{vx_p, ny + 2, w, 0, -PADW, w};
        const Lattice vyl{vy_p, ny + 1, w, 0, -PADW, w};
        advect_kernel<true><<<blocks, threads, 0, stream>>>(
            x, y, valid, vxl, vyl, dt, out_x, out_y, nx, K, n, dx, dy, x_lo,
            x_hi, y_lo, y_hi, reach, lx, inv_lx);
    } else {
        const Lattice vxl{vx_p, ny + 2, nx + 1, 0, 0, nx + 1};
        const Lattice vyl{vy_p, ny + 1, nx + 2, 0, 0, nx + 2};
        advect_kernel<false><<<blocks, threads, 0, stream>>>(
            x, y, valid, vxl, vyl, dt, out_x, out_y, nx, K, n, dx, dy, x_lo,
            x_hi, y_lo, y_hi, reach, lx, inv_lx);
    }
    return launch_status();
}
