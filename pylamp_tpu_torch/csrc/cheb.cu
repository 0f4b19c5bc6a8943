// Fused multi-iteration Chebyshev momentum smoother: `iters` coupled
// Chebyshev iterations of D^-1 A over [lam/4, lam] in one launch, and
// optionally the residual (rx - A ex', ry - A ey') of the final iterate.
//
// Replaces: pylamp_tpu/ops/pallas/cheb_kernel.py:chebyshev_smooth_pallas
// (with prep_smoother_eta), including the vy wall row ny that the TPU
// wrapper updated outside its kernel.
//
// Bound on the H100: bytes, at ~0.01 ms for 1024^2 (ex, ey, rx, ry,
// eta_s, eta_n read once, ex', ey' and the residual written once).  What
// holds a fused sweep back in practice is issue rate and latency: every
// point is applied `iters` (+1) times from shared memory, on a loaded
// region 1.3-2.6x the tile it writes.
//
// Design: 2-D temporal blocking.  A block owns a TY x 32 tile of the
// (ny+1, nx+1) point space (csrc/stencil.cuh) and loads it with a halo of
// he = iters (+1 with the residual) points into shared memory.  Every
// stencil reads only the 3x3 points around its own, so the k-th update is
// exact on the rings within he - k of the tile; only those are computed
// (the active region shrinks by one ring per update).
//   - The tile plan comes from the wrapper (ops/kernels/cheb.py
//     tile_plan): the tile height (32, 16 or 8 rows) is chosen per level
//     so that the small levels (256^2; 512x128, 256x64) spread over more
//     SMs, and the +1 point row and column fold into the last tile row
//     and column.
//   - The kernel is instantiated per depth he, so the shared-memory row
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
//     pointwise, as stencil.cuh does.
//   - Per-level constants (1/dx, 1/dy, 2/dx^2, ...) are hoisted and the
//     diagonals inverted once: the sweep multiplies where stencil.cuh
//     divides.  This reassociates the arithmetic (a quotient a / dx
//     becomes a * (1/dx), two roundings instead of one, and
//     2 eta (dv / dx) / dx becomes (2 / dx^2) eta dv), which moves each
//     result by a few f32 units in the last place against the plain
//     version's division order: the sweep is held to the fp tolerance of
//     the reference's reassociated kernel (2e-5 of max |ref|).
//   - Periodic side walls (kernel template switch P): interior tiles run
//     the same branch-free path; edge tiles load the x-periodic lattice
//     (vy, eta_n, ry at column gi mod nx, and vx, eta_s, rx with column nx
//     read as column 0) and keep only the top and bottom walls
//     (sweep_stencil.cuh P).  The seam columns 0 and nx take half the
//     wrapped row and half the wrapped Jacobi diagonal, so the residual
//     form emits rx as equal halves there.  Both seam columns are computed
//     from the same loaded values in the same order, so they stay
//     bit-identical.  This reads vx, rx and eta_s as seam-consistent
//     (column nx equal to column 0), which every vector of the periodic
//     multigrid is.  The P = false kernels are the wall form, unchanged.
// The coefficient table and kbnd come from device memory (no host sync).
// No atomics: a launch is deterministic.
#include "common.cuh"
#include "sweep_stencil.cuh"

namespace {

constexpr int NT = 512;      // threads per block
constexpr int TX = 32;       // tile width (points)
constexpr int MAX_HE = 7;    // deepest fused sweep (cheb.py MAX_DEPTH)
constexpr int PLANES = 6;    // ex, ey (two buffers each), eta_s, eta_n

// shared-memory row stride and loaded points per thread at depth HE (the
// tallest tile: 32 rows)
template <int HE>
struct Depth {
    static constexpr int SX = TX + 1 + 2 * HE;
    static constexpr int NQ = (SX * SX + NT - 1) / NT;
};

struct SweepArgs {
    const float* ex;
    const float* ey;
    const float* rx;
    const float* ry;
    const float* es;
    const float* en;
    const float* coeffs;
    float* ox;
    float* oy;
    float* fx;
    float* fy;
    int iters, zero_init, emit;
    int ty, nty, ntx;  // tile plan: tile rows, tiles down and across
};

// packed per-point code: ring | updated vx | updated vy
constexpr int RING_MASK = 15;
constexpr int HAS_X = 1 << 4;
constexpr int HAS_Y = 1 << 5;

template <int HE, bool W, bool P>
__device__ __forceinline__ void tile_sweep(const SweepArgs& a,
                                           const SweepConsts& c, float kb,
                                           float* smem, int j0, int i0,
                                           int LY, int TYc, int TXc) {
    constexpr int SX = Depth<HE>::SX, NQ = Depth<HE>::NQ;
    const int npl = LY * SX, LX = TXc + 2 * HE;
    // planes: [ex, ey] of buffer 0, [ex, ey] of buffer 1, eta_s, eta_n
    float* s_es = smem + 4 * npl;
    float* s_en = smem + 5 * npl;
    const int iters = a.iters, m = iters + (a.emit ? 1 : 0);
    const int W1 = c.nx + 1, tid = threadIdx.x;

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
        smem[p] = (hx && !a.zero_init) ? a.ex[gj * W1 + mi] : 0.0f;
        smem[npl + p] = (hy && !a.zero_init) ? a.ey[gj * c.nx + mi] : 0.0f;
        s_es[p] = hs ? a.es[gj * W1 + mi] : 0.0f;
        s_en[p] = hn ? a.en[gj * c.nx + mi] : 0.0f;
        const bool upd = ring <= m - 1;  // updated at least once
        if (upd && hx) r_x[q] = a.rx[gj * W1 + mi];
        if (upd && hy) r_y[q] = a.ry[gj * c.nx + mi];
        code[q] = ring | ((upd && hx) ? HAS_X : 0) | ((upd && hy) ? HAS_Y : 0);
    }
    __syncthreads();

    // inverse Jacobi diagonals (stencil.cuh stencil_dvx / stencil_dvy)
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
                if (resid) {
                    a.ox[gj * W1 + gi] = ex[p];
                    a.fx[gj * W1 + gi] = res;
                } else {
                    s_x[q] = c1 * s_x[q] + c2 * res * i_x[q];
                    const float e = ex[p] + s_x[q];
                    if (last) a.ox[gj * W1 + gi] = e;
                    else nx_[p] = e;
                }
            }
            if (cd & HAS_Y) {
                const float ay = apply ? apply_y<W, P>(ex, ey, s_es, s_en, p,
                                                       gj, gi, SX, kb, c)
                                       : 0.0f;
                const float res = r_y[q] - ay;
                // (P: column nx carries vy's column-0 alias, not written)
                const bool own_y = !P || gi < c.nx;
                if (resid) {
                    if (own_y) {
                        a.oy[gj * c.nx + gi] = ey[p];
                        a.fy[gj * c.nx + gi] = res;
                    }
                } else {
                    s_y[q] = c1 * s_y[q] + c2 * res * i_y[q];
                    const float e = ey[p] + s_y[q];
                    if (!last) ny_[p] = e;
                    else if (own_y) a.oy[gj * c.nx + gi] = e;
                }
            }
        }
        if (!last) __syncthreads();  // every update precedes the next read
        cur ^= 1;
    }
}

template <int HE, bool P>
__global__ void __launch_bounds__(NT, 1)
cheb_kernel(SweepArgs a, SweepConsts c, const float* __restrict__ kbp) {
    extern __shared__ float smem[];
    const int by = blockIdx.y, bx = blockIdx.x;
    const int cj0 = by * a.ty, ci0 = bx * TX;
    // the last tile row / column also takes the +1 point row / column
    const int TYc = (by == a.nty - 1) ? c.ny + 1 - cj0 : a.ty;
    const int TXc = (bx == a.ntx - 1) ? c.nx + 1 - ci0 : TX;
    const int j0 = cj0 - HE, i0 = ci0 - HE;
    const int LY = TYc + 2 * HE, LX = TXc + 2 * HE;
    const float kb = __ldg(kbp);
    // no wall, no missing storage anywhere in the loaded region
    const bool interior = j0 >= 0 && i0 >= 0 && j0 + LY <= c.ny
                          && i0 + LX <= c.nx;
    if (interior)
        tile_sweep<HE, false, false>(a, c, kb, smem, j0, i0, LY, TYc, TXc);
    else
        tile_sweep<HE, true, P>(a, c, kb, smem, j0, i0, LY, TYc, TXc);
}

template <int HE>
size_t smem_bytes(int ty) {
    return PLANES * sizeof(float) * (ty + 1 + 2 * HE) * Depth<HE>::SX;
}

// the instantiation for depth HE (P: periodic side walls)
template <int HE, bool P>
int launch_he(const SweepArgs& a, const SweepConsts& c, const float* kb,
              cudaStream_t stream) {
    if ((a.ty + 1 + 2 * HE) * Depth<HE>::SX > Depth<HE>::NQ * NT)
        return static_cast<int>(cudaErrorInvalidValue);
    // the tallest tile's planes, set once
    static const cudaError_t attr = cudaFuncSetAttribute(
        cheb_kernel<HE, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<HE>(TX)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    cheb_kernel<HE, P><<<dim3(a.ntx, a.nty), NT, smem_bytes<HE>(a.ty),
                         stream>>>(a, c, kb);
    return launch_status();
}

template <bool P>
int launch_depth(int he, const SweepArgs& a, const SweepConsts& c,
                 const float* kb, cudaStream_t stream) {
    switch (he) {
        case 1: return launch_he<1, P>(a, c, kb, stream);
        case 2: return launch_he<2, P>(a, c, kb, stream);
        case 3: return launch_he<3, P>(a, c, kb, stream);
        case 4: return launch_he<4, P>(a, c, kb, stream);
        case 5: return launch_he<5, P>(a, c, kb, stream);
        case 6: return launch_he<6, P>(a, c, kb, stream);
        default: return launch_he<7, P>(a, c, kb, stream);
    }
}

template <int HE, bool P>
int info_he(int ty, int* out) {
    const void* fn = reinterpret_cast<const void*>(cheb_kernel<HE, P>);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<HE>(TX)));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    const size_t smem = smem_bytes<HE>(ty);
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

}  // namespace

PYLAMP_EXPORT int launch_cheb(const float* ex, const float* ey,
                              const float* rx, const float* ry,
                              const float* eta_s, const float* eta_n,
                              const float* coeffs, const float* kb,
                              float* ox, float* oy, float* fx, float* fy,
                              int ny, int nx, float dx, float dy,
                              float s_top, float s_bottom, float s_left,
                              float s_right, int iters, int h, int zero_init,
                              int emit, int ty, int periodic,
                              cudaStream_t stream) {
    const int he = iters + (emit ? 1 : 0);
    if (iters < 1 || he > h || he > MAX_HE || ty < 1 || ty > TX || ny < 1
        || nx < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const SweepConsts c = sweep_consts(ny, nx, dx, dy, s_top, s_bottom,
                                       s_left, s_right);
    const SweepArgs a{ex, ey, rx, ry, eta_s, eta_n, coeffs, ox, oy, fx, fy,
                      iters, zero_init, emit, ty, (ny + ty - 1) / ty,
                      (nx + TX - 1) / TX};
    return periodic ? launch_depth<true>(he, a, c, kb, stream)
                    : launch_depth<false>(he, a, c, kb, stream);
}

// Occupancy of the depth-he instantiation (P: the periodic form) with
// tiles of ty rows: out =
// {registers per thread, static shared bytes, local (spill) bytes per
// thread, resident blocks per SM, threads per block, dynamic shared bytes}.
template <bool P>
int info_depth(int he, int ty, int* out) {
    switch (he) {
        case 1: return info_he<1, P>(ty, out);
        case 2: return info_he<2, P>(ty, out);
        case 3: return info_he<3, P>(ty, out);
        case 4: return info_he<4, P>(ty, out);
        case 5: return info_he<5, P>(ty, out);
        case 6: return info_he<6, P>(ty, out);
        case 7: return info_he<7, P>(ty, out);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

PYLAMP_EXPORT int cheb_kernel_info(int he, int ty, int periodic, int* out) {
    return periodic ? info_depth<true>(he, ty, out)
                    : info_depth<false>(he, ty, out);
}
