// The whole coarse sub-V-cycle (every level from the fusion start down to
// the coarsest) in one launch, returning the correction.
//
// Replaces: pylamp_tpu/ops/pallas/coarse_vcycle_kernel.py:
// coarse_vcycle_pallas, with its per-level frame smoother
// (cheb_block_kernel.py:frame_cheb_sweep) and its dense transfer matrices
// (solvers/transfer_mats.py), which this kernel applies as the stencils of
// solvers/mg.py restrict_* / prolong_*.
//
// Bound on the H100: latency.  The levels hold under 1 MB together and a
// cycle is ~40 dependent stages (every Chebyshev update reads what the
// previous one wrote across the level), so what sets the time is the
// cost of a stage: its barrier and its memory round trips.
//
// Design: one thread-block cluster of 8 CTAs (the portable size) keeps
// every level in distributed shared memory for the whole cycle; device memory is touched once per launch (the rhs, the
// viscosities and the inverse Jacobi diagonals in, the correction out).
//   - The large levels (max(ny, nx) >= 64: 128^2 and 64^2 of FK,
//     128x32 and 64x16 of sticky air) are split into strips of point rows,
//     one per CTA.  A strip holds its rows plus one ghost row on each
//     side.  An update writes its own edge rows into the neighbours' ghost
//     rows (distributed shared memory stores), and the stages are
//     separated by cluster.sync().  Row strips on the 4:1 sticky-air levels
//     too (not the longer axis): one code path, and the two ghost rows of
//     a strip of 129 points cost as little as two ghost columns would.
//   - The small levels live in CTA 0's shared memory, worked on by a
//     subset of its threads sized to the level, one point per thread
//     (named barrier 1; one warp and __syncwarp on the 4^2 level with its
//     32 coarsest iterations, three warps on 8^2 and 16x4); the other CTAs
//     wait at the next cluster.sync.
//   - Each owned point's Chebyshev state sits in registers for a sweep,
//     its rhs and inverse diagonal in shared memory; the iterate is
//     double-buffered in shared memory, so one barrier per update; the
//     emitted residual goes into the free buffer, where the restriction
//     reads it (remote rows through map_shared_rank).
//   - The plan (strips, thread counts, shared-memory offsets) comes from
//     the wrapper (ops/kernels/coarse_vcycle.py cluster_plan) in a device
//     array of CoarseLevel; each CTA copies it, the Chebyshev tables and
//     kbnd into static shared memory first.  The launcher checks with
//     cudaOccupancyMaxActiveClusters that one cluster fits.
//   - Capacity: the FK and sticky-air hierarchies from 128^2 and 128x32
//     take 191 KB and 68 KB per CTA.  A start level a cluster cannot hold
//     (192^2, 160^2 and 224^2, from FK at nx = 384, 640, 448 and their
//     doubles) is not fused from: the wrapper's fusion gate
//     (coarse_fuse_start) moves the start one level down, and the level
//     above runs unfused.  A cooperative grid with the levels in L2 would
//     hold them, at a grid-wide barrier per stage; no size the benchmarks
//     run needs it, so there is none.
// Arithmetic: the stencils of sweep_stencil.cuh (reciprocals hoisted; see
// there) and the prep's inverse diagonals, so the cycle is held to the fp
// tolerance of the reference's kernel.  No atomics: deterministic.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sweep_stencil.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;      // threads per CTA
constexpr int NQ = 5;        // owned points per thread and level, at most
constexpr int MAXLEV = 16;
constexpr int CL = 8;        // CTAs per cluster
constexpr int MAXIT = 64;    // Chebyshev iterations per sweep, at most
constexpr int SMEM_MAX = 232448;
// the planes of a level, each rows x (nx+1) floats
enum { P_EX0 = 0, P_EY0, P_EX1, P_EY1, P_ES, P_EN, P_IX, P_IY, P_RX, P_RY,
       PLANES };

}  // namespace

// one level of the sub-hierarchy with its place in the cluster (ctypes
// mirror: ops/kernels/coarse_vcycle.py)
struct CoarseLevel {
    const float* es;   // (ny+1, nx+1) viscosities
    const float* en;   // (ny, nx)
    const float* idx;  // (ny, nx+1) inverse Jacobi diagonal, vx lattice
    const float* idy;  // (ny+1, nx)
    int ny, nx;
    float dx, dy;
    int split;  // 1: point rows split into strips over the CTAs; 0: CTA 0
    int nthr;   // threads per CTA that work on the level
    int rows;   // rows each CTA stores: its largest strip + 2 ghost rows
    int off;    // offset of the level's planes in shared memory (floats)
    int lo[CL + 1];  // CTA s owns point rows lo[s] .. lo[s+1]-1
};

namespace {

// the kernel's static shared memory: its copies of the plan, the Chebyshev
// tables and kbnd (ops/kernels/coarse_vcycle.py SMEM_STATIC)
constexpr int SMEM_STATIC =
    sizeof(CoarseLevel) * MAXLEV + sizeof(float) * MAXLEV * (2 * MAXIT + 1);

struct CoarseArgs {
    const float* rx;
    const float* ry;
    float* ex;
    float* ey;
    const float* coeffs;  // (nlev, maxit, 2)
    const float* kbnds;   // (nlev,)
    int nlev, maxit, pre, post, coarse_iters;
    float s_top, s_bottom, s_left, s_right;
};

// this CTA's rows of level L: [lo, hi)
struct Rows {
    int lo, hi;
};

__device__ __forceinline__ Rows own_rows(const CoarseLevel& L, int rank) {
    if (L.split) return Rows{L.lo[rank], L.lo[rank + 1]};
    return rank == 0 ? Rows{0, L.ny + 1} : Rows{0, 0};
}

__device__ __forceinline__ float* plane(float* smem, const CoarseLevel& L,
                                        int k) {
    return smem + L.off + k * L.rows * (L.nx + 1);
}

// plane k of level L at global point (j, i), wherever in the cluster it
// lives: the owner of row j (lo[s] = s * (ny+1) / CTAs, cluster_plan's
// partition) and its local address
__device__ __forceinline__ float* level_at(cg::cluster_group& cl,
                                           float* smem, const CoarseLevel& L,
                                           int k, int j, int i) {
    const int s = L.split ? ((j + 1) * CL - 1) / (L.ny + 1) : 0;
    float* p = plane(smem, L, k) + (j - L.lo[s] + 1) * (L.nx + 1) + i;
    return s == static_cast<int>(cl.block_rank()) ? p
                                                  : cl.map_shared_rank(p, s);
}

__device__ __forceinline__ float level_get(cg::cluster_group& cl,
                                           float* smem, const CoarseLevel& L,
                                           int k, int j, int i) {
    return *level_at(cl, smem, L, k, j, i);
}

// a barrier of the first `nthr` threads of a CTA
__device__ __forceinline__ void subset_sync(int nthr) {
    if (nthr == NT)
        __syncthreads();
    else if (nthr == 32)
        __syncwarp();
    else
        asm volatile("bar.sync 1, %0;" ::"r"(nthr) : "memory");
}

// the barrier between stages on level L: the cluster for a split level,
// CTA 0 otherwise
__device__ __forceinline__ void stage_sync(cg::cluster_group& cl,
                                           const CoarseLevel& L) {
    if (L.split)
        cl.sync();
    else if (cl.block_rank() == 0)
        __syncthreads();
}

// packed owned point: column | row << 10 | has vx << 21 | has vy << 22
constexpr int HAS_X = 1 << 21;
constexpr int HAS_Y = 1 << 22;
constexpr int VALID = 1 << 23;

// write an updated value of an own edge row into the neighbour's ghost row
__device__ __forceinline__ void push_ghost(cg::cluster_group& cl,
                                           const CoarseLevel& L, int rank,
                                           float* pl, int j, int i, float v,
                                           const Rows& r) {
    const int W = L.nx + 1;
    if (j == r.lo && rank > 0)
        *cl.map_shared_rank(pl + (j - L.lo[rank - 1] + 1) * W + i,
                            rank - 1) = v;
    if (j == r.hi - 1 && rank + 1 < CL)
        *cl.map_shared_rank(pl + i, rank + 1) = v;  // its ghost row 0
}

// `iters` Chebyshev iterations on level l (+ the residual of the final
// iterate into the free buffer with `emit`); zero_init starts from e = 0.
// `cur` (bit l of the mask) says which buffer holds the iterate.
__device__ void level_sweep(cg::cluster_group& cl, float* smem,
                            const CoarseLevel& L, const CoarseArgs& a, int l,
                            int iters, bool zero_init, bool emit,
                            unsigned& curmask) {
    const int rank = cl.block_rank(), tid = threadIdx.x;
    const Rows r = own_rows(L, rank);
    const int W = L.nx + 1, npl = L.rows * W, nthr = L.nthr;
    const bool works = tid < nthr && r.hi > r.lo;
    const SweepConsts c = sweep_consts(L.ny, L.nx, L.dx, L.dy, a.s_top,
                                       a.s_bottom, a.s_left, a.s_right);
    const float kb = a.kbnds[l];
    const float* co = a.coeffs + 2 * l * a.maxit;
    float* base = smem + L.off;
    const float* es = base + P_ES * npl;
    const float* en = base + P_EN * npl;
    const int npts = (r.hi - r.lo) * W;

    const float* rx = base + P_RX * npl;
    const float* ry = base + P_RY * npl;
    const float* ix = base + P_IX * npl;
    const float* iy = base + P_IY * npl;
    int code[NQ];
    float s_x[NQ], s_y[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int p = tid + q * nthr;
        code[q] = 0;
        s_x[q] = s_y[q] = 0.0f;
        if (!works || p >= npts) continue;
        const int lr = p / W, i = p - lr * W, j = r.lo + lr;
        const bool hx = j < L.ny, hy = i < L.nx;
        code[q] = i | (j << 10) | (hx ? HAS_X : 0) | (hy ? HAS_Y : 0) | VALID;
    }

    unsigned cur = (curmask >> l) & 1u;
    const int m = iters + (emit ? 1 : 0);
    for (int k = 1; k <= m; ++k) {
        const bool apply = !(zero_init && k == 1);  // A(0) = 0
        const bool resid = k > iters;  // the emitted residual's application
        float c1 = 0.0f, c2 = 0.0f;
        if (!resid) {
            c1 = co[2 * (k - 1)];
            c2 = co[2 * (k - 1) + 1];
        }
        const float* ex = base + (cur ? P_EX1 : P_EX0) * npl;
        const float* ey = ex + npl;
        float* nx_ = base + (cur ? P_EX0 : P_EX1) * npl;
        float* ny_ = nx_ + npl;
        if (works) {
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const int cd = opaque(code[q]);
                if (!(cd & VALID)) continue;
                const int i = cd & 1023, j = (cd >> 10) & 2047;
                const int loc = (j - r.lo + 1) * W + i;
                if (cd & HAS_X) {
                    const float ax = apply ? apply_x<true>(ex, ey, es, en, loc,
                                                           j, i, W, kb, c)
                                           : 0.0f;
                    const float res = rx[loc] - ax;
                    if (resid) {
                        nx_[loc] = res;
                    } else {
                        s_x[q] = c1 * s_x[q] + c2 * res * ix[loc];
                        const float e = (apply || !zero_init ? ex[loc] : 0.0f)
                                        + s_x[q];
                        nx_[loc] = e;
                        if (L.split) push_ghost(cl, L, rank, nx_, j, i, e, r);
                    }
                }
                if (cd & HAS_Y) {
                    const float ay = apply ? apply_y<true>(ex, ey, es, en, loc,
                                                           j, i, W, kb, c)
                                           : 0.0f;
                    const float res = ry[loc] - ay;
                    if (resid) {
                        ny_[loc] = res;
                    } else {
                        s_y[q] = c1 * s_y[q] + c2 * res * iy[loc];
                        const float e = (apply || !zero_init ? ey[loc] : 0.0f)
                                        + s_y[q];
                        ny_[loc] = e;
                        if (L.split) push_ghost(cl, L, rank, ny_, j, i, e, r);
                    }
                }
            }
        }
        if (L.split)
            cl.sync();
        else if (works)
            subset_sync(nthr);
        if (!resid) cur ^= 1u;
    }
    curmask = (curmask & ~(1u << l)) | (cur << l);
}

// P^T / 4 of the fine level's emitted residual (in F's free buffer) into
// the coarse right-hand side: solvers/mg.py restrict_vx / restrict_vy.
// Coarse row J is computed where fine row 2J lives (most of its fine rows
// are local there) and stored where coarse row J lives.
__device__ void restrict_level(cg::cluster_group& cl, float* smem,
                               const CoarseLevel& F, const CoarseLevel& C,
                               const CoarseArgs& a, unsigned curF) {
    const int rank = cl.block_rank(), tid = threadIdx.x;
    const Rows r = own_rows(F, rank);
    if (tid >= F.nthr || r.hi <= r.lo) return;
    const int NY = C.ny, NX = C.nx, CW = NX + 1;
    const int fny = F.ny, fnx = F.nx;
    const int kx = curF ? P_EX0 : P_EX1;  // the free buffer of F
    const int ky = kx + 1;
    const int J0 = (r.lo + 1) / 2, J1 = (r.hi + 1) / 2;  // 2J in [lo, hi)
    for (int p = tid; p < (J1 - J0) * CW; p += F.nthr) {
        const int J = J0 + p / CW, I = p - (J - J0) * CW;
        if (J < NY) {
            float v = 0.0f;
            if (I != 0 && I != NX) {
                float g[3];
#pragma unroll
                for (int t = 0; t < 3; ++t) {
                    const int col = 2 * I - 1 + t;
                    const float up =
                        (J == 0) ? a.s_top * level_get(cl, smem, F, kx, 0, col)
                                 : level_get(cl, smem, F, kx, 2 * J - 1, col);
                    const float dn =
                        (2 * J + 2 == fny)
                            ? a.s_bottom
                                  * level_get(cl, smem, F, kx, fny - 1, col)
                            : level_get(cl, smem, F, kx, 2 * J + 2, col);
                    g[t] = (0.25f * up
                            + 0.75f * level_get(cl, smem, F, kx, 2 * J, col)
                            + 0.75f * level_get(cl, smem, F, kx, 2 * J + 1, col)
                            + 0.25f * dn)
                           / 2.0f;
                }
                v = (0.5f * g[0] + 1.0f * g[1] + 0.5f * g[2]) / 2.0f;
            }
            *level_at(cl, smem, C, P_RX, J, I) = v;
        }
        if (I < NX) {
            float v = 0.0f;
            if (J != 0 && J != NY) {
                float g[3];
#pragma unroll
                for (int t = 0; t < 3; ++t) {
                    const int row = 2 * J - 1 + t;
                    const float lf =
                        (I == 0) ? a.s_left * level_get(cl, smem, F, ky, row, 0)
                                 : level_get(cl, smem, F, ky, row, 2 * I - 1);
                    const float rt =
                        (2 * I + 2 == fnx)
                            ? a.s_right
                                  * level_get(cl, smem, F, ky, row, fnx - 1)
                            : level_get(cl, smem, F, ky, row, 2 * I + 2);
                    g[t] = (0.25f * lf
                            + 0.75f * level_get(cl, smem, F, ky, row, 2 * I)
                            + 0.75f * level_get(cl, smem, F, ky, row, 2 * I + 1)
                            + 0.25f * rt)
                           / 2.0f;
                }
                v = (0.5f * g[0] + 1.0f * g[1] + 0.5f * g[2]) / 2.0f;
            }
            *level_at(cl, smem, C, P_RY, J, I) = v;
        }
    }
}

// coarse vx correction, bilinear along y at coarse column I (zero on the
// Dirichlet columns); fine row j
__device__ __forceinline__ float prolong_col_x(cg::cluster_group& cl,
                                               float* smem,
                                               const CoarseLevel& C, int kx,
                                               const CoarseArgs& a, int j,
                                               int I) {
    if (I == 0 || I == C.nx) return 0.0f;
    const int J = j >> 1;
    const float mid = level_get(cl, smem, C, kx, J, I);
    if ((j & 1) == 0) {
        const float up = (J == 0) ? a.s_top * level_get(cl, smem, C, kx, 0, I)
                                  : level_get(cl, smem, C, kx, J - 1, I);
        return 0.25f * up + 0.75f * mid;
    }
    const float dn = (J == C.ny - 1) ? a.s_bottom * mid
                                     : level_get(cl, smem, C, kx, J + 1, I);
    return 0.75f * mid + 0.25f * dn;
}

// coarse vy correction, bilinear along x at coarse row J (zero on the
// Dirichlet rows); fine column i
__device__ __forceinline__ float prolong_row_y(cg::cluster_group& cl,
                                               float* smem,
                                               const CoarseLevel& C, int ky,
                                               const CoarseArgs& a, int J,
                                               int i) {
    if (J == 0 || J == C.ny) return 0.0f;
    const int I = i >> 1, NX = C.nx;
    const float mid = level_get(cl, smem, C, ky, J, I);
    if ((i & 1) == 0) {
        const float lf = (I == 0) ? a.s_left * level_get(cl, smem, C, ky, J, 0)
                                  : level_get(cl, smem, C, ky, J, I - 1);
        return 0.25f * lf + 0.75f * mid;
    }
    const float rt = (I == NX - 1) ? a.s_right * mid
                                   : level_get(cl, smem, C, ky, J, I + 1);
    return 0.75f * mid + 0.25f * rt;
}

// F.e += P C.e (solvers/mg.py prolong_vx / prolong_vy), with the updated
// edge rows pushed into the neighbours' ghost rows
__device__ void prolong_add(cg::cluster_group& cl, float* smem,
                            const CoarseLevel& C, const CoarseLevel& F,
                            const CoarseArgs& a, unsigned curC,
                            unsigned curF) {
    const int rank = cl.block_rank(), tid = threadIdx.x;
    const Rows r = own_rows(F, rank);
    if (tid >= F.nthr || r.hi <= r.lo) return;
    const int ny = F.ny, nx = F.nx, W = nx + 1, npl = F.rows * W;
    const int ckx = curC ? P_EX1 : P_EX0, cky = ckx + 1;
    float* fex = smem + F.off + (curF ? P_EX1 : P_EX0) * npl;
    float* fey = fex + npl;
    for (int p = tid; p < (r.hi - r.lo) * W; p += F.nthr) {
        const int lr = p / W, i = p - lr * W, j = r.lo + lr;
        const int loc = (lr + 1) * W + i;
        if (j < ny && i != 0 && i != nx) {
            const int I = i >> 1;
            const float v =
                (i & 1) ? 0.5f * (prolong_col_x(cl, smem, C, ckx, a, j, I)
                                  + prolong_col_x(cl, smem, C, ckx, a, j, I + 1))
                        : prolong_col_x(cl, smem, C, ckx, a, j, I);
            const float e = fex[loc] + v;
            fex[loc] = e;
            if (F.split) push_ghost(cl, F, rank, fex, j, i, e, r);
        }
        if (i < nx && j != 0 && j != ny) {
            const int J = j >> 1;
            const float v =
                (j & 1) ? 0.5f * (prolong_row_y(cl, smem, C, cky, a, J, i)
                                  + prolong_row_y(cl, smem, C, cky, a, J + 1, i))
                        : prolong_row_y(cl, smem, C, cky, a, J, i);
            const float e = fey[loc] + v;
            fey[loc] = e;
            if (F.split) push_ghost(cl, F, rank, fey, j, i, e, r);
        }
    }
}

// the level's read-only planes (viscosities with the ghost rows, inverse
// diagonals; level 0's rhs) from device memory
__device__ void load_level(float* smem, const CoarseLevel& L, int rank,
                           const CoarseArgs& a, bool first) {
    const Rows r = own_rows(L, rank);
    if (r.hi <= r.lo) return;
    const int W = L.nx + 1, npl = L.rows * W, ny = L.ny, nx = L.nx;
    float* base = smem + L.off;
    const int j0 = r.lo - 1;  // the upper ghost row
    for (int p = threadIdx.x; p < (r.hi - r.lo + 2) * W; p += NT) {
        const int lr = p / W, i = p - lr * W, j = j0 + lr;
        const bool in = j >= 0 && j <= ny;
        base[P_ES * npl + p] = in ? L.es[j * W + i] : 0.0f;
        base[P_EN * npl + p] = (in && j < ny && i < nx) ? L.en[j * nx + i]
                                                        : 0.0f;
        if (j < r.lo || j >= r.hi) continue;
        if (j < ny) {
            base[P_IX * npl + p] = L.idx[j * W + i];
            if (first) base[P_RX * npl + p] = a.rx[j * W + i];
        }
        if (i < nx) {
            base[P_IY * npl + p] = L.idy[j * nx + i];
            if (first) base[P_RY * npl + p] = a.ry[j * nx + i];
        }
    }
}

__global__ void __launch_bounds__(NT, 1)
coarse_vcycle_kernel(const CoarseLevel* __restrict__ levels, CoarseArgs a) {
    extern __shared__ float smem[];
    // the plan, the Chebyshev tables and kbnd, read once
    __shared__ CoarseLevel lv[MAXLEV];
    __shared__ float s_co[MAXLEV * 2 * MAXIT];
    __shared__ float s_kb[MAXLEV];
    cg::cluster_group cl = cg::this_cluster();
    const int rank = cl.block_rank(), n = a.nlev;
    constexpr int LW = sizeof(CoarseLevel) / sizeof(int);
    for (int t = threadIdx.x; t < n * LW; t += NT)
        reinterpret_cast<int*>(lv)[t] =
            reinterpret_cast<const int*>(levels)[t];
    for (int t = threadIdx.x; t < n * 2 * a.maxit; t += NT)
        s_co[t] = a.coeffs[t];
    for (int t = threadIdx.x; t < n; t += NT) s_kb[t] = a.kbnds[t];
    a.coeffs = s_co;
    a.kbnds = s_kb;
    __syncthreads();
    for (int l = 0; l < n; ++l) load_level(smem, lv[l], rank, a, l == 0);
    cl.sync();  // every CTA runs and has its planes before any remote access

    unsigned cur = 0;  // bit l: the buffer that holds level l's iterate
    for (int l = 0; l + 1 < n; ++l) {
        // pre-smooth from zero + the restriction-input residual
        level_sweep(cl, smem, lv[l], a, l, a.pre, true, true, cur);
        stage_sync(cl, lv[l]);
        restrict_level(cl, smem, lv[l], lv[l + 1], a, (cur >> l) & 1u);
        stage_sync(cl, lv[l]);
    }
    level_sweep(cl, smem, lv[n - 1], a, n - 1, a.coarse_iters, true, false,
                cur);
    for (int l = n - 2; l >= 0; --l) {
        stage_sync(cl, lv[l]);
        prolong_add(cl, smem, lv[l + 1], lv[l], a, (cur >> (l + 1)) & 1u,
                    (cur >> l) & 1u);
        stage_sync(cl, lv[l]);
        level_sweep(cl, smem, lv[l], a, l, a.post, false, false, cur);
    }

    // the correction on level 0's own rows (written by the level's
    // threads, read by all of the CTA's)
    stage_sync(cl, lv[0]);
    const CoarseLevel& L = lv[0];
    const Rows r = own_rows(L, rank);
    const int W = L.nx + 1, npl = L.rows * W;
    const float* ex = smem + L.off + ((cur & 1u) ? P_EX1 : P_EX0) * npl;
    const float* ey = ex + npl;
    for (int p = threadIdx.x; p < (r.hi - r.lo) * W; p += NT) {
        const int lr = p / W, i = p - lr * W, j = r.lo + lr;
        const int loc = (lr + 1) * W + i;
        if (j < L.ny) a.ex[j * W + i] = ex[loc];
        if (i < L.nx) a.ey[j * L.nx + i] = ey[loc];
    }
    cl.sync();  // no CTA leaves while another may still read its planes
}

// the launch configuration of one cluster
struct Launch {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    Launch(int smem, cudaStream_t stream) : cfg{}, attr{} {
        cfg.gridDim = dim3(CL);
        cfg.blockDim = dim3(NT);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = stream;
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = CL;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
    }
};

// the function attributes for `smem` bytes, and how many such clusters
// fit on the card at once
cudaError_t prepare(int smem, int* clusters) {
    static int set_smem = -1;
    if (smem > set_smem) {
        const cudaError_t err = cudaFuncSetAttribute(
            coarse_vcycle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (err != cudaSuccess) return err;
        set_smem = smem;
    }
    Launch l(smem, nullptr);
    return cudaOccupancyMaxActiveClusters(clusters, coarse_vcycle_kernel,
                                          &l.cfg);
}

}  // namespace

PYLAMP_EXPORT int launch_coarse_vcycle(
    const CoarseLevel* levels, const CoarseLevel* levels_dev, int nlev,
    const float* rx, const float* ry, float* ex, float* ey,
    const float* coeffs, const float* kbnds, int maxit, int pre, int post,
    int coarse_iters, float s_top, float s_bottom, float s_left,
    float s_right, int smem, cudaStream_t stream) {
    if (nlev < 2 || nlev > MAXLEV || maxit < pre || maxit < post
        || maxit < coarse_iters || pre < 1 || post < 1 || coarse_iters < 1
        || maxit > MAXIT || smem < 1
        || smem > SMEM_MAX - SMEM_STATIC)
        return static_cast<int>(cudaErrorInvalidValue);
    for (int l = 0; l < nlev; ++l) {
        const CoarseLevel& L = levels[l];
        const long end = static_cast<long>(L.off)
                         + static_cast<long>(PLANES) * L.rows * (L.nx + 1);
        if (L.nthr < 32 || L.nthr > NT || L.nthr % 32 != 0 || L.nx >= 1024
            || L.ny >= 2048 || end * 4 > smem)
            return static_cast<int>(cudaErrorInvalidValue);
    }
    // one cluster must fit at this shared-memory size (cached per size)
    static int last_smem = -1, last_fit = 0;
    if (smem != last_smem) {
        int clusters = 0;
        const cudaError_t err = prepare(smem, &clusters);
        if (err != cudaSuccess) return static_cast<int>(err);
        last_smem = smem;
        last_fit = clusters;
    }
    if (last_fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const CoarseArgs a{rx, ry, ex, ey, coeffs, kbnds, nlev, maxit, pre,
                       post, coarse_iters, s_top, s_bottom, s_left, s_right};
    Launch l(smem, stream);
    const cudaError_t err =
        cudaLaunchKernelEx(&l.cfg, coarse_vcycle_kernel, levels_dev, a);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_status();
}

// Occupancy at `smem` dynamic shared bytes: out = {registers per thread,
// static shared bytes, local (spill) bytes per thread, clusters resident at
// once, threads per CTA, CTAs per cluster}.
PYLAMP_EXPORT int coarse_vcycle_kernel_info(int smem, int* out) {
    int clusters = 0;
    cudaError_t err = prepare(smem, &clusters);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, coarse_vcycle_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = fa.numRegs;
    out[1] = static_cast<int>(fa.sharedSizeBytes);
    out[2] = static_cast<int>(fa.localSizeBytes);
    out[3] = clusters;
    out[4] = NT;
    out[5] = CL;
    return 0;
}
