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
// so device memory sees each input about once.  The tangential-BC ghosts
// are resolved inline from the wall signs (no padded copies), and kbnd /
// kcont come from a 2-element device array so a solve never syncs the
// host for them.  Arithmetic follows ops/stokes.py term for term.
#include "common.cuh"

namespace {

struct Saddle {
    const float* vx;     // (ny, nx+1)
    const float* vy;     // (ny+1, nx)
    const float* p;      // (ny, nx)
    const float* eta_s;  // (ny+1, nx+1)
    const float* eta_n;  // (ny, nx)
    int ny, nx;
    float dx, dy;
    float s_top, s_bottom, s_left, s_right;

    __device__ float VX(int j, int i) const { return vx[j * (nx + 1) + i]; }
    __device__ float VY(int j, int i) const { return vy[j * nx + i]; }
    __device__ float P(int j, int i) const { return p[j * nx + i]; }
    __device__ float EN(int j, int i) const { return eta_n[j * nx + i]; }

    // sxy at corner (J, I), J in 0..ny, I in 0..nx, ghosts inline
    __device__ float sxy(int J, int I) const {
        float above = (J == 0) ? s_top * VX(0, I) : VX(J - 1, I);
        float below = (J == ny) ? s_bottom * VX(ny - 1, I) : VX(J, I);
        float left = (I == 0) ? s_left * VY(J, 0) : VY(J, I - 1);
        float right = (I == nx) ? s_right * VY(J, nx - 1) : VY(J, I);
        float dvxdy = (below - above) / dy;
        float dvydx = (right - left) / dx;
        return eta_s[J * (nx + 1) + I] * (dvxdy + dvydx);
    }
    // sxx at cell (j, c)
    __device__ float sxx(int j, int c) const {
        return (2.0f * EN(j, c)) * ((VX(j, c + 1) - VX(j, c)) / dx);
    }
    // syy at cell (c, i)
    __device__ float syy(int c, int i) const {
        return (2.0f * EN(c, i)) * ((VY(c + 1, i) - VY(c, i)) / dy);
    }
};

__global__ void saddle_kernel(Saddle s, const float* __restrict__ kk,
                              float* __restrict__ rx, float* __restrict__ ry,
                              float* __restrict__ rc) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int ny = s.ny, nx = s.nx;
    if (i > nx || j > ny) return;
    const float kbnd = kk[0];
    const float kcont = kk[1];

    if (j < ny) {  // x-momentum row at vx node (j, i)
        float r;
        if (i == 0 || i == nx) {
            r = kbnd * s.VX(j, i);
        } else {
            r = -(s.sxx(j, i) - s.sxx(j, i - 1)) / s.dx
                - (s.sxy(j + 1, i) - s.sxy(j, i)) / s.dy
                + (s.P(j, i) - s.P(j, i - 1)) / s.dx;
        }
        rx[j * (nx + 1) + i] = r;
    }
    if (i < nx) {  // y-momentum row at vy node (j, i)
        float r;
        if (j == 0 || j == ny) {
            r = kbnd * s.VY(j, i);
        } else {
            r = -(s.syy(j, i) - s.syy(j - 1, i)) / s.dy
                - (s.sxy(j, i + 1) - s.sxy(j, i)) / s.dx
                + (s.P(j, i) - s.P(j - 1, i)) / s.dy;
        }
        ry[j * nx + i] = r;
    }
    if (j < ny && i < nx) {  // continuity at cell (j, i)
        float dvxdx = (s.VX(j, i + 1) - s.VX(j, i)) / s.dx;
        float dvydy = (s.VY(j + 1, i) - s.VY(j, i)) / s.dy;
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
                                cudaStream_t stream) {
    Saddle s{vx, vy, p, eta_s, eta_n, ny, nx, dx, dy,
             s_top, s_bottom, s_left, s_right};
    dim3 block(32, 8);
    saddle_kernel<<<grid2d(ny + 1, nx + 1, block), block, 0, stream>>>(
        s, kk, rx, ry, rc);
    return launch_status();
}

PYLAMP_EXPORT const char* pylamp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
