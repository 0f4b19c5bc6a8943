// The coupled momentum stencil of the staggered Stokes operator: the stress
// arithmetic of the saddle apply (saddle.cu, saddle_block.cu), the MG
// momentum apply (momentum.cu) and the per-shard Chebyshev sweep
// (cheb_block.cu via cheb_sweep.cuh).  The fused sweep (cheb.cu) and the
// coarse sub-V-cycle (coarse_vcycle.cu) use sweep_stencil.cuh, the same
// arithmetic with the reciprocals hoisted.
//
// Index space: "points" (j, i), j in 0..ny, i in 0..nx.  A point carries
// vx(j, i) when j < ny, vy(j, i) when i < nx, the corner viscosity
// es(j, i), and the cell viscosity en(j, i) when j < ny and i < nx.  Every
// stencil reads only the 3x3 points around its own, which is what makes
// the deep-halo argument of the fused sweeps work.
//
// Wall ghosts are resolved inline from the CURRENT boundary values (ghost
// = s * first interior row / column), so no padded copy is needed; the
// Dirichlet lines (vx columns 0 and nx, vy rows 0 and ny) have diagonal
// kbnd and operator row kbnd * v.  Arithmetic follows ops/stokes.py term
// for term.
//
// P (periodic side walls, a template switch; P = false is the wall form
// above, unchanged): vy's ghost columns wrap (the column left of 0 is
// nx - 1, the one right of nx - 1 is 0), and vx columns 0 and nx are one
// node whose row is the wrapped equation, half of it in each column.
// stencil_ax_seam computes that half row from column 0's neighbourhood
// exactly as ops/stokes.py does (sxx of cells 0 and nx - 1, sxy of corner
// column 0), and both seam columns return it, so they are bit-identical.
#pragma once

#include <cuda_runtime.h>

struct StencilCtx {
    int ny, nx;
    float dx, dy;
    float s_top, s_bottom, s_left, s_right;
};

// Acc provides vx(j, i), vy(j, i), es(j, i), en(j, i) at GLOBAL indices.

// sxy at corner (J, I), J in 0..ny, I in 0..nx
template <bool P = false, class Acc>
__device__ __forceinline__ float stencil_sxy(const Acc& a, const StencilCtx& c,
                                             int J, int I) {
    const float above = (J == 0) ? c.s_top * a.vx(0, I) : a.vx(J - 1, I);
    const float below = (J == c.ny) ? c.s_bottom * a.vx(c.ny - 1, I) : a.vx(J, I);
    float left, right;
    if constexpr (P) {
        left = a.vy(J, (I == 0) ? c.nx - 1 : I - 1);
        right = a.vy(J, (I == c.nx) ? 0 : I);
    } else {
        left = (I == 0) ? c.s_left * a.vy(J, 0) : a.vy(J, I - 1);
        right = (I == c.nx) ? c.s_right * a.vy(J, c.nx - 1) : a.vy(J, I);
    }
    return a.es(J, I) * ((below - above) / c.dy + (right - left) / c.dx);
}

// the periodic seam row at vx row j: half the wrapped equation (without
// the pressure gradient), from column 0's neighbourhood
template <class Acc>
__device__ __forceinline__ float stencil_ax_seam(const Acc& a,
                                                 const StencilCtx& c, int j) {
    const float sxx_r = (2.0f * a.en(j, 0)) * ((a.vx(j, 1) - a.vx(j, 0)) / c.dx);
    const float sxx_l = (2.0f * a.en(j, c.nx - 1))
                        * ((a.vx(j, c.nx) - a.vx(j, c.nx - 1)) / c.dx);
    return 0.5f * (-(sxx_r - sxx_l) / c.dx
                   - (stencil_sxy<true>(a, c, j + 1, 0)
                      - stencil_sxy<true>(a, c, j, 0)) / c.dy);
}

// (A e)_x at vx node (j, i), j < ny: -(d sxx/dx + d sxy/dy)
template <bool P = false, class Acc>
__device__ __forceinline__ float stencil_ax(const Acc& a, const StencilCtx& c,
                                            int j, int i, float kb) {
    if (i == 0 || i == c.nx) {
        if constexpr (P) return stencil_ax_seam(a, c, j);
        else return kb * a.vx(j, i);
    }
    const float sxx_r = (2.0f * a.en(j, i)) * ((a.vx(j, i + 1) - a.vx(j, i)) / c.dx);
    const float sxx_l = (2.0f * a.en(j, i - 1)) * ((a.vx(j, i) - a.vx(j, i - 1)) / c.dx);
    return -(sxx_r - sxx_l) / c.dx
           - (stencil_sxy<P>(a, c, j + 1, i) - stencil_sxy<P>(a, c, j, i)) / c.dy;
}

// (A e)_y at vy node (j, i), i < nx: -(d sxy/dx + d syy/dy)
template <bool P = false, class Acc>
__device__ __forceinline__ float stencil_ay(const Acc& a, const StencilCtx& c,
                                            int j, int i, float kb) {
    if (j == 0 || j == c.ny) return kb * a.vy(j, i);
    const float syy_d = (2.0f * a.en(j, i)) * ((a.vy(j + 1, i) - a.vy(j, i)) / c.dy);
    const float syy_u = (2.0f * a.en(j - 1, i)) * ((a.vy(j, i) - a.vy(j - 1, i)) / c.dy);
    return -(syy_d - syy_u) / c.dy
           - (stencil_sxy<P>(a, c, j, i + 1) - stencil_sxy<P>(a, c, j, i)) / c.dx;
}

// Jacobi diagonals (solvers/stokes_solver.py velocity_diagonals)
template <bool P = false, class Acc>
__device__ __forceinline__ float stencil_dvx(const Acc& a, const StencilCtx& c,
                                             int j, int i, float kb) {
    if (i == 0 || i == c.nx) {
        if constexpr (P)
            return 0.5f * (2.0f * (a.en(j, 0) + a.en(j, c.nx - 1)) / (c.dx * c.dx)
                           + (a.es(j + 1, 0) + a.es(j, 0)) / (c.dy * c.dy));
        else return kb;
    }
    return 2.0f * (a.en(j, i) + a.en(j, i - 1)) / (c.dx * c.dx)
           + (a.es(j + 1, i) + a.es(j, i)) / (c.dy * c.dy);
}

template <class Acc>
__device__ __forceinline__ float stencil_dvy(const Acc& a, const StencilCtx& c,
                                             int j, int i, float kb) {
    if (j == 0 || j == c.ny) return kb;
    return 2.0f * (a.en(j, i) + a.en(j - 1, i)) / (c.dy * c.dy)
           + (a.es(j, i + 1) + a.es(j, i)) / (c.dx * c.dx);
}

// Accessor over the row-major global arrays of one level.
struct GlobalAcc {
    const float* ex;  // (ny, nx+1)
    const float* ey;  // (ny+1, nx)
    const float* es_;  // (ny+1, nx+1)
    const float* en_;  // (ny, nx)
    int nx;
    __device__ __forceinline__ float vx(int j, int i) const { return ex[j * (nx + 1) + i]; }
    __device__ __forceinline__ float vy(int j, int i) const { return ey[j * nx + i]; }
    __device__ __forceinline__ float es(int j, int i) const { return es_[j * (nx + 1) + i]; }
    __device__ __forceinline__ float en(int j, int i) const { return en_[j * nx + i]; }
};
