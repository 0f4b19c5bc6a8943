// The fused Chebyshev sweep of one tile of the per-shard sweep on halo
// frames (cheb_block.cu), the role of
// pylamp_tpu/ops/pallas/cheb_block_kernel.py:frame_cheb_sweep.  The
// single-device sweep (cheb.cu) and the coarse sub-V-cycle
// (coarse_vcycle.cu) have their own Hopper designs over sweep_stencil.cuh.
//
// The Dirichlet lines have diagonal kbnd and operator row kbnd * v
// (stencil.cuh), so the recurrence updates them pointwise like every other
// point.
//
// 2-D temporal blocking: a thread block owns a TY x TX tile of the point
// space (stencil.cuh) and loads it with a halo of h points on every side
// into shared memory (ex, ey, eta_s, eta_n: four planes).  Every stencil
// reads only the 3x3 points around its own, so after m operator
// applications the outermost m rings of the loaded region are stale and
// the central tile stays exact while m <= h (h = iters, +1 with the
// emitted residual).  The pointwise recurrence state, the residual inputs
// and the Jacobi diagonals stay in registers; only the centre is written
// back.  Wall ghosts are resolved inline from current values and the
// Dirichlet lines evolve pointwise, so domain edges never go stale.
#pragma once

#include "stencil.cuh"

// One Chebyshev update of a recurrence state: k = 0 starts it from the
// residual alone (c1_0 = 0), later k carry the previous step.
__device__ __forceinline__ float cheb_step(int k, float c1, float c2,
                                           float prev, float resid, float diag) {
    return (k == 0) ? c2 * resid / diag : c1 * prev + c2 * resid / diag;
}

namespace cheb_tile {

constexpr int TX = 32;        // centre tile: points per row
constexpr int TY = 32;        // centre tile: rows
constexpr int NT = 256;       // threads per block
constexpr int MAX_H = 7;      // deepest fused sweep (cheb.py MAX_DEPTH)
constexpr int MAXQ = ((TY + 2 * MAX_H) * (TX + 2 * MAX_H) + NT - 1) / NT;

// dynamic shared memory of a tile with halo h: four planes
inline size_t smem_bytes(int h) {
    return 4 * sizeof(float) * (TX + 2 * h) * (TY + 2 * h);
}

struct SharedAcc {
    const float* ex;
    const float* ey;
    const float* es_;
    const float* en_;
    int j0, i0, LX;  // point (j0, i0) sits at local (0, 0)
    __device__ __forceinline__ int at(int j, int i) const {
        return (j - j0) * LX + (i - i0);
    }
    __device__ __forceinline__ float vx(int j, int i) const { return ex[at(j, i)]; }
    __device__ __forceinline__ float vy(int j, int i) const { return ey[at(j, i)]; }
    __device__ __forceinline__ float es(int j, int i) const { return es_[at(j, i)]; }
    __device__ __forceinline__ float en(int j, int i) const { return en_[at(j, i)]; }
};

// The sweep of the tile whose loaded region starts at point (j0, i0), in
// the index space of the StencilCtx ``c``.  ``Src`` says where the data
// lives:
//   ex/ey/es/en/rx/ry(j, i)  load a point (0 where it has no storage);
//   inside(j, i)             the point has storage (may be updated);
//   owns(j, i)               a centre point this tile writes;
//   put_x/put_y(j, i, e, f)  store the iterate (and, with emit, f = r - A e).
template <class Src>
__device__ __forceinline__ void sweep(const Src& src, const StencilCtx& c,
                                      float* smem, int j0, int i0, int h,
                                      const float* __restrict__ coeffs,
                                      float kb, int iters, int zero_init,
                                      int emit) {
    const int LX = TX + 2 * h, LY = TY + 2 * h, npts = LX * LY;
    float* s_ex = smem;
    float* s_ey = s_ex + npts;
    float* s_es = s_ey + npts;
    float* s_en = s_es + npts;
    const int ny = c.ny, nx = c.nx;
    const int tid = threadIdx.x;

    for (int p = tid; p < npts; p += NT) {
        const int gj = j0 + p / LX, gi = i0 + p % LX;
        const bool in_j = gj >= 0 && gj <= ny, in_i = gi >= 0 && gi <= nx;
        const bool has_x = in_i && gj >= 0 && gj < ny;
        const bool has_y = in_j && gi >= 0 && gi < nx;
        s_ex[p] = (has_x && !zero_init) ? src.ex(gj, gi) : 0.0f;
        s_ey[p] = (has_y && !zero_init) ? src.ey(gj, gi) : 0.0f;
        s_es[p] = (in_j && in_i) ? src.es(gj, gi) : 0.0f;
        s_en[p] = (has_x && has_y) ? src.en(gj, gi) : 0.0f;
    }
    SharedAcc a{s_ex, s_ey, s_es, s_en, j0, i0, LX};

    // per-point registers; a point is "active" when its 3x3 neighbourhood
    // lies in the loaded region (outer ring: read-only, goes stale)
    float r_x[MAXQ], r_y[MAXQ], d_x[MAXQ], d_y[MAXQ];
    float st_x[MAXQ], st_y[MAXQ], a_x[MAXQ], a_y[MAXQ];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < MAXQ; ++q) {
        const int p = tid + q * NT;
        const int lj = p / LX, li = p % LX, gj = j0 + lj, gi = i0 + li;
        const bool act = p < npts && lj >= 1 && lj <= LY - 2 && li >= 1
                         && li <= LX - 2 && src.inside(gj, gi);
        st_x[q] = st_y[q] = a_x[q] = a_y[q] = 0.0f;
        r_x[q] = r_y[q] = 0.0f;
        d_x[q] = d_y[q] = 1.0f;
        if (act && gj >= 0 && gj < ny && gi >= 0 && gi <= nx) {
            r_x[q] = src.rx(gj, gi);
            d_x[q] = stencil_dvx(a, c, gj, gi, kb);
        }
        if (act && gj >= 0 && gj <= ny && gi >= 0 && gi < nx) {
            r_y[q] = src.ry(gj, gi);
            d_y[q] = stencil_dvy(a, c, gj, gi, kb);
        }
    }

    const int napply = iters + (emit ? 1 : 0);
    for (int k = 0; k < napply; ++k) {
        const bool skip_apply = zero_init && k == 0;  // A(0) = 0
        if (!skip_apply) {
#pragma unroll
            for (int q = 0; q < MAXQ; ++q) {
                const int p = tid + q * NT;
                const int lj = p / LX, li = p % LX, gj = j0 + lj, gi = i0 + li;
                const bool act = p < npts && lj >= 1 && lj <= LY - 2
                                 && li >= 1 && li <= LX - 2
                                 && src.inside(gj, gi);
                if (act && gj >= 0 && gj < ny && gi >= 0 && gi <= nx)
                    a_x[q] = stencil_ax(a, c, gj, gi, kb);
                if (act && gj >= 0 && gj <= ny && gi >= 0 && gi < nx)
                    a_y[q] = stencil_ay(a, c, gj, gi, kb);
            }
        }
        __syncthreads();  // every read of e precedes the update
        if (k == iters) break;  // the emitted residual's application
        const float c1 = coeffs[2 * k], c2 = coeffs[2 * k + 1];
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) {
            const int p = tid + q * NT;
            const int lj = p / LX, li = p % LX, gj = j0 + lj, gi = i0 + li;
            const bool act = p < npts && lj >= 1 && lj <= LY - 2 && li >= 1
                             && li <= LX - 2 && src.inside(gj, gi);
            if (act && gj >= 0 && gj < ny && gi >= 0 && gi <= nx) {
                const float res = skip_apply ? r_x[q] : r_x[q] - a_x[q];
                st_x[q] = cheb_step(k, c1, c2, st_x[q], res, d_x[q]);
                s_ex[p] += st_x[q];
            }
            if (act && gj >= 0 && gj <= ny && gi >= 0 && gi < nx) {
                const float res = skip_apply ? r_y[q] : r_y[q] - a_y[q];
                st_y[q] = cheb_step(k, c1, c2, st_y[q], res, d_y[q]);
                s_ey[p] += st_y[q];
            }
        }
        __syncthreads();  // every update precedes the next application
    }

    // write the centre tile
#pragma unroll
    for (int q = 0; q < MAXQ; ++q) {
        const int p = tid + q * NT;
        const int lj = p / LX, li = p % LX, gj = j0 + lj, gi = i0 + li;
        if (p >= npts || lj < h || lj >= h + TY || li < h || li >= h + TX
            || !src.owns(gj, gi))
            continue;
        if (gj < ny && gi <= nx) src.put_x(gj, gi, s_ex[p], r_x[q] - a_x[q]);
        if (gj <= ny && gi < nx) src.put_y(gj, gi, s_ey[p], r_y[q] - a_y[q]);
    }
}

}  // namespace cheb_tile
