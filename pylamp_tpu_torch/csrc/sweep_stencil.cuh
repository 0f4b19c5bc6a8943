// The momentum stencil of the redesigned sweeps (the fused Chebyshev
// sweeps cheb.cu and cheb_block.cu through cheb_tile.cuh, and the cluster
// coarse sub-V-cycle coarse_vcycle.cu) on planes of the (ny+1, nx+1) point
// space held in shared memory, row stride LX: local index p is point
// (gj, gi), p +- 1 its row neighbours and p +- LX its column neighbours;
// the tiled applies (saddle.cu, momentum.cu through saddle_tile.cuh) take
// its SweepConsts (the per-shard stencil, saddle_block.cu, through
// saddle_tile.cuh too).  The arithmetic is ops/stokes.py's with the
// per-level constants hoisted: 1/dx, 1/dy, 2/dx^2, 2/dy^2 multiply where
// the plain version divides.  That reassociation
// (a / dx -> a * (1/dx): two roundings instead of one;
// 2 eta (dv / dx) / dx -> (2 / dx^2) eta dv) moves each result by a few
// f32 units in the last place against the plain versions.
//
// W (walls): the point may lie on a wall row or column, and its ghosts
// are resolved inline from current values (ghost = s * first interior
// row / column) and the Dirichlet lines return kbnd * v.  W = false is
// the branch-free form for points whose 3x3 neighbourhood touches no wall.
//
// P (periodic side walls, with W; P = false is the form above,
// unchanged): the planes hold the x-periodic lattice (column gi holds
// physical column gi mod nx, so vx column nx is column 0 and the ghosts
// are real neighbours), only the top and bottom walls remain, and the seam
// columns 0 and nx return half the wrapped vx row (ops/stokes.py's seam
// convention).
#pragma once

#include <cuda_runtime.h>

// per-level constants of the sweep
struct SweepConsts {
    int ny, nx;
    float idx, idy;    // 1/dx, 1/dy
    float cxx, cyy;    // 2/dx^2, 2/dy^2 (normal stresses)
    float dxx, dyy;    // 1/dx^2, 1/dy^2 (shear part of the diagonals)
    float s_top, s_bottom, s_left, s_right;
};

__host__ __device__ inline SweepConsts sweep_consts(
    int ny, int nx, float dx, float dy, float s_top, float s_bottom,
    float s_left, float s_right) {
    const float idx = 1.0f / dx, idy = 1.0f / dy;
    return SweepConsts{ny, nx, idx, idy, 2.0f * idx * idx, 2.0f * idy * idy,
                       idx * idx, idy * idy, s_top, s_bottom, s_left,
                       s_right};
}

// v, opaque to the optimiser: what a loop body computes from it stays in
// the body, so the per-point addresses of an unrolled loop over a
// thread's points are not all hoisted into registers of their own
__device__ __forceinline__ int opaque(int v) {
    int r;
    asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"(v));
    return r;
}

// sxy at the corner of local point q, global (J, I)
template <bool W, bool P = false>
__device__ __forceinline__ float sxy_at(const float* vx, const float* vy,
                                        const float* es, int q, int J, int I,
                                        int LX, const SweepConsts& c) {
    float above, below, left, right;
    if (W) {
        above = (J == 0) ? c.s_top * vx[q] : vx[q - LX];
        below = (J == c.ny) ? c.s_bottom * vx[q - LX] : vx[q];
        if constexpr (P) {
            left = vy[q - 1];
            right = vy[q];
        } else {
            left = (I == 0) ? c.s_left * vy[q] : vy[q - 1];
            right = (I == c.nx) ? c.s_right * vy[q - 1] : vy[q];
        }
    } else {
        above = vx[q - LX];
        below = vx[q];
        left = vy[q - 1];
        right = vy[q];
    }
    return es[q] * ((below - above) * c.idy + (right - left) * c.idx);
}

// (A e)_x at the vx node of local point p, global (gj, gi)
template <bool W, bool P = false>
__device__ __forceinline__ float apply_x(const float* vx, const float* vy,
                                         const float* es, const float* en,
                                         int p, int gj, int gi, int LX,
                                         float kb, const SweepConsts& c) {
    if constexpr (!P) {
        if (W && (gi == 0 || gi == c.nx)) return kb * vx[p];
    }
    const float v = vx[p];
    const float n_r = en[p] * (vx[p + 1] - v);
    const float n_l = en[p - 1] * (v - vx[p - 1]);
    const float r = -c.cxx * (n_r - n_l)
                    - c.idy * (sxy_at<W, P>(vx, vy, es, p + LX, gj + 1, gi,
                                            LX, c)
                               - sxy_at<W, P>(vx, vy, es, p, gj, gi, LX, c));
    if constexpr (P) {
        if (gi == 0 || gi == c.nx) return 0.5f * r;  // the seam half row
    }
    return r;
}

// (A e)_y at the vy node of local point p
template <bool W, bool P = false>
__device__ __forceinline__ float apply_y(const float* vx, const float* vy,
                                         const float* es, const float* en,
                                         int p, int gj, int gi, int LX,
                                         float kb, const SweepConsts& c) {
    if (W && (gj == 0 || gj == c.ny)) return kb * vy[p];
    const float v = vy[p];
    const float n_d = en[p] * (vy[p + LX] - v);
    const float n_u = en[p - LX] * (v - vy[p - LX]);
    return -c.cyy * (n_d - n_u)
           - c.idx * (sxy_at<W, P>(vx, vy, es, p + 1, gj, gi + 1, LX, c)
                      - sxy_at<W, P>(vx, vy, es, p, gj, gi, LX, c));
}
