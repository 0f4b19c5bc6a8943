// The tile of the fused Chebyshev sweeps: `iters` coupled Chebyshev
// iterations of D^-1 A over one TY x 32 tile of the (ny+1, nx+1) point
// space (saddle.cu's index space), and optionally the residual of
// the final iterate.  One body for the single-device sweep (kernel 5,
// cheb.cu: the planes come from the level's global arrays) and the
// per-shard sweep (kernel 8, cheb_block.cu: the planes come from one
// shard's halo frame); TileIO says where a tile's planes are read and its
// outputs written.
//
// Design (2-D temporal blocking): a block loads its tile with a halo of
// he = iters (+1 with the residual) points into shared memory.  Every
// stencil reads only the 3x3 points around its own, so the k-th update is
// exact on the rings within he - k of the tile; only those are computed
// (the active region shrinks by one ring per update).
//   - The body is instantiated per depth he, so the shared-memory row
//     stride SX = 33 + 2 he and the points per thread are constants:
//     every neighbour of a point is an immediate offset from one address
//     register, which keeps a thread's points within ~7 registers each.
//   - Fixed ownership: thread t owns the loaded points t + q * NT
//     (q < NQ); each point's ring and lattice classes are computed once,
//     at the load, and kept packed in one register.  Neighbours come from
//     shared memory (a row of the tile is contiguous there, so a warp
//     reads conflict-free); the recurrence state, the right-hand side and
//     the inverse Jacobi diagonals stay in registers.
//   - The iterate is double-buffered in shared memory: an update reads
//     one buffer and writes the other, so one barrier per update.
//   - A tile whose loaded region touches no wall takes the branch-free
//     path (no storage or wall tests); edge tiles resolve wall ghosts
//     inline from current values and update the Dirichlet lines
//     pointwise through the kbnd recurrence (sweep_stencil.cuh W).
//   - Per-level constants (1/dx, 1/dy, 2/dx^2, ...) are hoisted and the
//     diagonals inverted once: the sweep multiplies where the plain
//     version divides.  This reassociates the arithmetic (a quotient a / dx
//     becomes a * (1/dx), two roundings instead of one, and
//     2 eta (dv / dx) / dx becomes (2 / dx^2) eta dv), which moves each
//     result by a few f32 units in the last place against the plain
//     versions' division order: both sweeps are held to 2e-5 of max |ref|.
//   - Periodic side walls (template switch P, kernel 5 only): interior
//     tiles run the same branch-free path; edge tiles load the x-periodic
//     lattice (vy, eta_n, ry at column gi mod nx, and vx, eta_s, rx with
//     column nx read as column 0) and keep only the top and bottom walls
//     (sweep_stencil.cuh P).  The seam columns 0 and nx take half the
//     wrapped row and half the wrapped Jacobi diagonal, so the residual
//     form emits rx as equal halves there.  Both seam columns are computed
//     from the same loaded values in the same order, so they stay
//     bit-identical.  This reads vx, rx and eta_s as seam-consistent
//     (column nx equal to column 0), which every vector of the periodic
//     multigrid is.
// The coefficient table and kbnd come from device memory (no host sync).
// No atomics: a launch is deterministic.
#pragma once

#include <type_traits>

#include "sweep_stencil.cuh"

namespace cheb_tile {

constexpr int NT = 512;      // threads per block
constexpr int TX = 32;       // tile width (points)
constexpr int MAX_HE = 7;    // deepest fused sweep (cheb.py MAX_DEPTH)
constexpr int PLANES = 6;    // ex, ey (two buffers each), eta_s, eta_n

// shared-memory row stride and loaded points per thread at depth HE (the
// tallest tile: 33 rows, a tile row and the folded +1 point row)
template <int HE>
struct Depth {
    static constexpr int SX = TX + 1 + 2 * HE;
    static constexpr int NQ = (SX * SX + NT - 1) / NT;
};

// dynamic shared memory of a block with tiles of ty rows at depth HE
template <int HE>
constexpr size_t smem_bytes(int ty) {
    return PLANES * sizeof(float) * (ty + 1 + 2 * HE) * Depth<HE>::SX;
}

// whether the loaded region of a tile of ty (+1) rows fits the threads'
// fixed points
template <int HE>
constexpr bool fits(int ty) {
    return (ty + 1 + 2 * HE) * Depth<HE>::SX <= Depth<HE>::NQ * NT;
}

// Where a tile's planes come from and go to, at point (gj, gi) of the
// index space whose walls sit at rows 0 / ny and columns 0 / nx:
// ex, rx, es at [gj * lx + gi] (the vx lattice's row stride), ey, ry, en
// at [gj * ly + gi], the outputs ox, fx at [gj * sx + gi] and oy, fy at
// [gj * sy + gi].  Kernel 5 points them at the level's arrays; kernel 8 at
// one shard's frames, shifted so that the same indices reach them.
struct TileIO {
    const float* ex;
    const float* ey;
    const float* rx;
    const float* ry;
    const float* es;
    const float* en;
    float* ox;
    float* oy;
    float* fx;
    float* fy;
    int lx, ly, sx, sy;
};

// the sweep's iteration count and forms, and the Chebyshev table
struct SweepCtl {
    const float* coeffs;
    int iters, zero_init, emit;
};

// packed per-point code: ring | updated vx | updated vy
constexpr int RING_MASK = 15;
constexpr int HAS_X = 1 << 4;
constexpr int HAS_Y = 1 << 5;

template <int HE, bool W, bool P>
__device__ __forceinline__ void tile_sweep(const TileIO& io,
                                           const SweepCtl& a,
                                           const SweepConsts& c, float kb,
                                           float* smem, int j0, int i0,
                                           int LY, int TYc, int TXc) {
    constexpr int SX = Depth<HE>::SX, NQ = Depth<HE>::NQ;
    const int npl = LY * SX, LX = TXc + 2 * HE;
    // planes: [ex, ey] of buffer 0, [ex, ey] of buffer 1, eta_s, eta_n
    float* s_es = smem + 4 * npl;
    float* s_en = smem + 5 * npl;
    const int iters = a.iters, m = iters + (a.emit ? 1 : 0);
    const int tid = threadIdx.x;

    int code[NQ];
    float r_x[NQ], r_y[NQ], i_x[NQ], i_y[NQ], s_x[NQ], s_y[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int p = tid + q * NT;
        r_x[q] = r_y[q] = i_x[q] = i_y[q] = s_x[q] = s_y[q] = 0.0f;
        code[q] = RING_MASK;  // never active
        const int lj = p / SX, li = p - lj * SX;
        if (lj >= LY || li >= LX) continue;
        const int gj = j0 + lj, gi = i0 + li;
        const int ring = max(max(max(HE - lj, lj - (HE + TYc - 1)),
                                 max(HE - li, li - (HE + TXc - 1))), 0);
        bool hx = true, hy = true, hs = true, hn = true;
        int mi = gi;  // the column the point's values are read from
        if constexpr (P) {  // every column exists: gi mod nx
            mi = gi < 0 ? gi + c.nx : (gi >= c.nx ? gi - c.nx : gi);
            hx = gj >= 0 && gj < c.ny;
            hy = hs = gj >= 0 && gj <= c.ny;
            hn = hx;
        } else if (W) {
            const bool in_j = gj >= 0 && gj <= c.ny;
            const bool in_i = gi >= 0 && gi <= c.nx;
            hx = in_i && gj >= 0 && gj < c.ny;
            hy = in_j && gi >= 0 && gi < c.nx;
            hs = in_j && in_i;
            hn = hx && hy;
        }
        const int at_x = gj * io.lx + mi, at_y = gj * io.ly + mi;
        smem[p] = (hx && !a.zero_init) ? io.ex[at_x] : 0.0f;
        smem[npl + p] = (hy && !a.zero_init) ? io.ey[at_y] : 0.0f;
        s_es[p] = hs ? io.es[at_x] : 0.0f;
        s_en[p] = hn ? io.en[at_y] : 0.0f;
        const bool upd = ring <= m - 1;  // updated at least once
        if (upd && hx) r_x[q] = io.rx[at_x];
        if (upd && hy) r_y[q] = io.ry[at_y];
        code[q] = ring | ((upd && hx) ? HAS_X : 0) | ((upd && hy) ? HAS_Y : 0);
    }
    __syncthreads();

    // inverse Jacobi diagonals (ops/stokes.py's momentum diagonals)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int cd = code[q], p = tid + q * NT;
        const int lj = p / SX, li = p - lj * SX;
        if (cd & HAS_X) {
            const int gi = i0 + li;
            float d;
            if constexpr (P) {  // the seam: half the wrapped diagonal
                d = c.cxx * (s_en[p] + s_en[p - 1])
                    + c.dyy * (s_es[p + SX] + s_es[p]);
                if (gi == 0 || gi == c.nx) d = 0.5f * d;
            } else {
                d = (W && (gi == 0 || gi == c.nx))
                        ? kb
                        : c.cxx * (s_en[p] + s_en[p - 1])
                              + c.dyy * (s_es[p + SX] + s_es[p]);
            }
            i_x[q] = 1.0f / d;
        }
        if (cd & HAS_Y) {
            const int gj = j0 + lj;
            const float d = (W && (gj == 0 || gj == c.ny))
                                ? kb
                                : c.cyy * (s_en[p] + s_en[p - SX])
                                      + c.dxx * (s_es[p + 1] + s_es[p]);
            i_y[q] = 1.0f / d;
        }
    }

    int cur = 0;
    for (int k = 1; k <= m; ++k) {
        const int lim = m - k;  // rings still needed after this update
        const bool apply = !(a.zero_init && k == 1);  // A(0) = 0
        const bool resid = k > iters;  // the emitted residual's application
        const bool last = k == m;
        float c1 = 0.0f, c2 = 0.0f;
        if (!resid) {
            c1 = __ldg(a.coeffs + 2 * (k - 1));
            c2 = __ldg(a.coeffs + 2 * (k - 1) + 1);
        }
        const float* ex = smem + cur * 2 * npl;
        const float* ey = ex + npl;
        float* nx_ = smem + (cur ^ 1) * 2 * npl;
        float* ny_ = nx_ + npl;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            const int cd = code[q];
            if ((cd & RING_MASK) > lim) continue;
            const int p = tid + q * NT;
            const int lj = p / SX, li = p - lj * SX;
            const int gj = j0 + lj, gi = i0 + li;
            if (cd & HAS_X) {
                const float ax = apply ? apply_x<W, P>(ex, ey, s_es, s_en, p,
                                                       gj, gi, SX, kb, c)
                                       : 0.0f;
                const float res = r_x[q] - ax;
                const int o = gj * io.sx + gi;
                if (resid) {
                    io.ox[o] = ex[p];
                    io.fx[o] = res;
                } else {
                    s_x[q] = c1 * s_x[q] + c2 * res * i_x[q];
                    const float e = ex[p] + s_x[q];
                    if (last) io.ox[o] = e;
                    else nx_[p] = e;
                }
            }
            if (cd & HAS_Y) {
                const float ay = apply ? apply_y<W, P>(ex, ey, s_es, s_en, p,
                                                       gj, gi, SX, kb, c)
                                       : 0.0f;
                const float res = r_y[q] - ay;
                const int o = gj * io.sy + gi;
                // (P: column nx carries vy's column-0 alias, not written)
                const bool own_y = !P || gi < c.nx;
                if (resid) {
                    if (own_y) {
                        io.oy[o] = ey[p];
                        io.fy[o] = res;
                    }
                } else {
                    s_y[q] = c1 * s_y[q] + c2 * res * i_y[q];
                    const float e = ey[p] + s_y[q];
                    if (!last) ny_[p] = e;
                    else if (own_y) io.oy[o] = e;
                }
            }
        }
        if (!last) __syncthreads();  // every update precedes the next read
        cur ^= 1;
    }
}

// The sweep of the tile whose centre (TYc x TXc points) starts at point
// (cj0, ci0): the branch-free form where its loaded region touches no wall
// and holds no point without storage, the wall form (P: periodic side
// walls) elsewhere.
template <int HE, bool P>
__device__ __forceinline__ void sweep_tile(const TileIO& io,
                                           const SweepCtl& a,
                                           const SweepConsts& c, float kb,
                                           float* smem, int cj0, int ci0,
                                           int TYc, int TXc) {
    const int j0 = cj0 - HE, i0 = ci0 - HE;
    const int LY = TYc + 2 * HE, LX = TXc + 2 * HE;
    const bool interior = j0 >= 0 && i0 >= 0 && j0 + LY <= c.ny
                          && i0 + LX <= c.nx;
    if (interior)
        tile_sweep<HE, false, false>(io, a, c, kb, smem, j0, i0, LY, TYc,
                                     TXc);
    else
        tile_sweep<HE, true, P>(io, a, c, kb, smem, j0, i0, LY, TYc, TXc);
}

// the centre extent of tile `b` of `n` along an axis of `points` points
// (tiles of `t`; the last takes what is left: t + 1 where the +1 point
// row or column folds into it)
__device__ __forceinline__ int tile_extent(int b, int n, int t, int points) {
    return (b == n - 1) ? points - b * t : t;
}

// Runs `launch(std::integral_constant<int, HE>)` for HE = he (1..MAX_HE).
template <class F>
int with_depth(int he, F&& launch) {
    switch (he) {
        case 1: return launch(std::integral_constant<int, 1>{});
        case 2: return launch(std::integral_constant<int, 2>{});
        case 3: return launch(std::integral_constant<int, 3>{});
        case 4: return launch(std::integral_constant<int, 4>{});
        case 5: return launch(std::integral_constant<int, 5>{});
        case 6: return launch(std::integral_constant<int, 6>{});
        case 7: return launch(std::integral_constant<int, 7>{});
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Occupancy of kernel `fn` with `smem` dynamic shared bytes, its largest
// (`smem_max`) allowed first: out = {registers per thread, static shared
// bytes, local (spill) bytes per thread, resident blocks per SM, threads
// per block, dynamic shared bytes}.
inline int kernel_info(const void* fn, size_t smem_max, size_t smem,
                       int* out) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_max));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NT, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = fa.numRegs;
    out[1] = static_cast<int>(fa.sharedSizeBytes);
    out[2] = static_cast<int>(fa.localSizeBytes);
    out[3] = blocks;
    out[4] = NT;
    out[5] = static_cast<int>(smem);
    return 0;
}

}  // namespace cheb_tile
