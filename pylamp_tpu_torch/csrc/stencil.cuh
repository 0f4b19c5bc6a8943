// The coupled momentum stencil of the staggered Stokes operator, one point
// at a time with IEEE divisions: the arithmetic of the per-shard saddle
// stencil (saddle_block.cu), its only user.  The single-device applies
// (saddle.cu, momentum.cu through saddle_tile.cuh), the fused sweeps
// (cheb.cu, cheb_block.cu through cheb_tile.cuh) and the coarse
// sub-V-cycle (coarse_vcycle.cu) use sweep_stencil.cuh, the same
// arithmetic with the reciprocals hoisted.
//
// Index space: "points" (j, i), j in 0..ny, i in 0..nx.  A point carries
// vx(j, i) when j < ny, vy(j, i) when i < nx, the corner viscosity
// es(j, i), and the cell viscosity en(j, i) when j < ny and i < nx.  Every
// stencil reads only the 3x3 points around its own.
//
// Wall ghosts are resolved inline from the CURRENT boundary values (ghost
// = s * first interior row / column), so no padded copy is needed; the
// Dirichlet lines (vx columns 0 and nx, vy rows 0 and ny) have operator
// row kbnd * v.  Arithmetic follows ops/stokes.py term for term.
#pragma once

#include <cuda_runtime.h>

struct StencilCtx {
    int ny, nx;
    float dx, dy;
    float s_top, s_bottom, s_left, s_right;
};

// Acc provides vx(j, i), vy(j, i), es(j, i), en(j, i) at GLOBAL indices.

// sxy at corner (J, I), J in 0..ny, I in 0..nx
template <class Acc>
__device__ __forceinline__ float stencil_sxy(const Acc& a, const StencilCtx& c,
                                             int J, int I) {
    const float above = (J == 0) ? c.s_top * a.vx(0, I) : a.vx(J - 1, I);
    const float below = (J == c.ny) ? c.s_bottom * a.vx(c.ny - 1, I) : a.vx(J, I);
    const float left = (I == 0) ? c.s_left * a.vy(J, 0) : a.vy(J, I - 1);
    const float right = (I == c.nx) ? c.s_right * a.vy(J, c.nx - 1) : a.vy(J, I);
    return a.es(J, I) * ((below - above) / c.dy + (right - left) / c.dx);
}

// (A e)_x at vx node (j, i), j < ny: -(d sxx/dx + d sxy/dy)
template <class Acc>
__device__ __forceinline__ float stencil_ax(const Acc& a, const StencilCtx& c,
                                            int j, int i, float kb) {
    if (i == 0 || i == c.nx) return kb * a.vx(j, i);
    const float sxx_r = (2.0f * a.en(j, i)) * ((a.vx(j, i + 1) - a.vx(j, i)) / c.dx);
    const float sxx_l = (2.0f * a.en(j, i - 1)) * ((a.vx(j, i) - a.vx(j, i - 1)) / c.dx);
    return -(sxx_r - sxx_l) / c.dx
           - (stencil_sxy(a, c, j + 1, i) - stencil_sxy(a, c, j, i)) / c.dy;
}

// (A e)_y at vy node (j, i), i < nx: -(d sxy/dx + d syy/dy)
template <class Acc>
__device__ __forceinline__ float stencil_ay(const Acc& a, const StencilCtx& c,
                                            int j, int i, float kb) {
    if (j == 0 || j == c.ny) return kb * a.vy(j, i);
    const float syy_d = (2.0f * a.en(j, i)) * ((a.vy(j + 1, i) - a.vy(j, i)) / c.dy);
    const float syy_u = (2.0f * a.en(j - 1, i)) * ((a.vy(j, i) - a.vy(j - 1, i)) / c.dy);
    return -(syy_d - syy_u) / c.dy
           - (stencil_sxy(a, c, j, i + 1) - stencil_sxy(a, c, j, i)) / c.dx;
}
