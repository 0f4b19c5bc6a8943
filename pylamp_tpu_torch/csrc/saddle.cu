// Full Stokes saddle-point apply (rx, ry, rc) for the FGMRES outer
// iterations.
//
// Replaces: pylamp_tpu/ops/pallas/stokes_kernel.py:saddle_apply_pallas
// (with prep_eta_pallas).
//
// Bound on the H100: memory.  Per call at 1024^2 it reads vx, vy, p,
// eta_s, eta_n (5.25 M floats, 21 MB) and writes rx, ry, rc (3.15 M
// floats, 12.6 MB): ~34 MB, ~10 us at 3.35 TB/s, against ~25 flops per
// output point.
//
// Design: one thread per point of the (ny+1, nx+1) index space; the
// thread writes rx, ry and rc wherever its point lies on those lattices.
// The neighbour reads of a 32x8 block overlap and are served from L1/L2,
// so device memory sees each input about once.  The momentum rows are the
// stencil of stencil.cuh (shared with momentum.cu) plus the pressure
// gradient; the tangential-BC ghosts are resolved inline from the wall
// signs (no padded copies), and kbnd / kcont come from a 2-element device
// array so a solve never syncs the host for them.
//
// Periodic side walls (template switch P, launched when `periodic` is
// set; the P = false kernel is the wall form, unchanged): vy's ghost
// columns wrap, and the threads of both seam columns (i = 0 and i = nx)
// evaluate the same half row (stencil.cuh stencil_ax_seam) plus half the
// wrapped pressure gradient, so the two columns are bit-identical.  The
// seam adds O(ny) work to O(ny nx).
#include "common.cuh"
#include "stencil.cuh"

namespace {

template <bool P>
__global__ void saddle_kernel(GlobalAcc a, StencilCtx c,
                              const float* __restrict__ p,
                              const float* __restrict__ kk,
                              float* __restrict__ rx, float* __restrict__ ry,
                              float* __restrict__ rc) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int ny = c.ny, nx = c.nx;
    if (i > nx || j > ny) return;
    const float kbnd = kk[0];
    const float kcont = kk[1];

    if (j < ny) {  // x-momentum row at vx node (j, i)
        float r = stencil_ax<P>(a, c, j, i, kbnd);
        if (i != 0 && i != nx) {
            r = r + (p[j * nx + i] - p[j * nx + i - 1]) / c.dx;
        } else if constexpr (P) {
            r = r + 0.5f * ((p[j * nx] - p[j * nx + nx - 1]) / c.dx);
        }
        rx[j * (nx + 1) + i] = r;
    }
    if (i < nx) {  // y-momentum row at vy node (j, i)
        float r = stencil_ay<P>(a, c, j, i, kbnd);
        if (j != 0 && j != ny) r = r + (p[j * nx + i] - p[(j - 1) * nx + i]) / c.dy;
        ry[j * nx + i] = r;
    }
    if (j < ny && i < nx) {  // continuity at cell (j, i)
        const float dvxdx = (a.vx(j, i + 1) - a.vx(j, i)) / c.dx;
        const float dvydy = (a.vy(j + 1, i) - a.vy(j, i)) / c.dy;
        rc[j * nx + i] = kcont * (dvxdx + dvydy);
    }
}

}  // namespace

PYLAMP_EXPORT int launch_saddle(const float* vx, const float* vy,
                                const float* p, const float* eta_s,
                                const float* eta_n, const float* kk,
                                float* rx, float* ry, float* rc, int ny,
                                int nx, float dx, float dy, float s_top,
                                float s_bottom, float s_left, float s_right,
                                int periodic, cudaStream_t stream) {
    const GlobalAcc a{vx, vy, eta_s, eta_n, nx};
    const StencilCtx c{ny, nx, dx, dy, s_top, s_bottom, s_left, s_right};
    dim3 block(32, 8);
    if (periodic)
        saddle_kernel<true><<<grid2d(ny + 1, nx + 1, block), block, 0,
                              stream>>>(a, c, p, kk, rx, ry, rc);
    else
        saddle_kernel<false><<<grid2d(ny + 1, nx + 1, block), block, 0,
                               stream>>>(a, c, p, kk, rx, ry, rc);
    return launch_status();
}

PYLAMP_EXPORT const char* pylamp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
