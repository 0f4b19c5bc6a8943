// The whole coarse sub-V-cycle (every level from the fusion start down to
// the coarsest) in one launch, returning the correction.
//
// Replaces: pylamp_tpu/ops/pallas/coarse_vcycle_kernel.py:
// coarse_vcycle_pallas, with its per-level frame smoother
// (cheb_block_kernel.py:frame_cheb_sweep, here cheb_sweep.cuh) and its
// dense transfer matrices (solvers/transfer_mats.py), which this kernel
// applies as the stencils of solvers/mg.py restrict_* / prolong_*.
//
// Bound on the H100: launches and latency.  The levels below 256 cells
// hold under 1 MB together (L2-resident), and the plain V-cycle spends
// its time issuing ~1,000 tiny tensor operations per cycle.  Here one
// launch does all of it.
//
// Design: ONE block of 1024 threads walks the levels.  Blocks of a grid
// run in no order on Hopper, and every stage of a V-cycle reads what the
// previous stage wrote across the whole level, so the stages are
// separated by __syncthreads() inside the block.  Level data (the
// restricted residuals, iterates, the Chebyshev state and the operator
// scratch) lives in global scratch that the wrapper allocates once per
// solve; at these sizes it stays in L2.  Each Chebyshev iteration is two
// stages: all operator applications, then all pointwise updates (the
// recurrence state is per point).  Wall ghosts are re-derived from current
// values inside the stencil, so wall physics is exact on every iteration.
#include "common.cuh"
#include "cheb_sweep.cuh"

namespace {

constexpr int NT = 1024;
constexpr int MAXLEV = 16;

}  // namespace

// one level of the sub-hierarchy (ctypes mirror: ops/kernels/coarse_vcycle.py)
struct CoarseLevel {
    const float* es;  // (ny+1, nx+1)
    const float* en;  // (ny, nx)
    const float* rx;  // (ny, nx+1) right-hand side
    const float* ry;  // (ny+1, nx)
    float* ex;        // (ny, nx+1) iterate
    float* ey;        // (ny+1, nx)
    float* sx;        // Chebyshev recurrence state, vx lattice
    float* sy;        // vy lattice
    float* ax;        // operator scratch / emitted residual, vx lattice
    float* ay;        // vy lattice
    int ny, nx;
    float dx, dy;
};

namespace {

struct CoarseParams {
    CoarseLevel lv[MAXLEV];
    int nlev, maxit, pre, post, coarse_iters;
    float s_top, s_bottom, s_left, s_right;
};

__device__ StencilCtx ctx_of(const CoarseParams& P, const CoarseLevel& L) {
    return StencilCtx{L.ny, L.nx, L.dx, L.dy,
                      P.s_top, P.s_bottom, P.s_left, P.s_right};
}

// `iters` Chebyshev iterations on one level (+ the residual of the final
// iterate into ax/ay with `emit`); zero_init starts from e = 0.
__device__ void level_sweep(const CoarseParams& P, const CoarseLevel& L,
                            const float* co, float kb, int iters,
                            bool zero_init, bool emit) {
    const StencilCtx c = ctx_of(P, L);
    const int ny = L.ny, nx = L.nx, W = nx + 1;
    const int np = (ny + 1) * W;
    const GlobalAcc a{L.ex, L.ey, L.es, L.en, nx};
    if (zero_init) {
        for (int p = threadIdx.x; p < np; p += NT) {
            const int j = p / W, i = p % W;
            if (j < ny) L.ex[j * W + i] = 0.0f;
            if (i < nx) L.ey[j * nx + i] = 0.0f;
        }
        __syncthreads();
    }
    const int napply = iters + (emit ? 1 : 0);
    for (int k = 0; k < napply; ++k) {
        const bool skip_apply = zero_init && k == 0;  // A(0) = 0
        if (!skip_apply) {
            for (int p = threadIdx.x; p < np; p += NT) {
                const int j = p / W, i = p % W;
                if (j < ny) L.ax[j * W + i] = stencil_ax(a, c, j, i, kb);
                if (i < nx) L.ay[j * nx + i] = stencil_ay(a, c, j, i, kb);
            }
        }
        __syncthreads();  // every read of e precedes the update
        if (k == iters) {  // emit: residual of the final iterate
            for (int p = threadIdx.x; p < np; p += NT) {
                const int j = p / W, i = p % W;
                if (j < ny) L.ax[j * W + i] = L.rx[j * W + i] - L.ax[j * W + i];
                if (i < nx) L.ay[j * nx + i] = L.ry[j * nx + i] - L.ay[j * nx + i];
            }
            __syncthreads();
            break;
        }
        const float c1 = co[2 * k], c2 = co[2 * k + 1];
        for (int p = threadIdx.x; p < np; p += NT) {
            const int j = p / W, i = p % W;
            if (j < ny) {
                const int q = j * W + i;
                const float res = skip_apply ? L.rx[q] : L.rx[q] - L.ax[q];
                const float s = cheb_step(k, c1, c2, L.sx[q], res,
                                          stencil_dvx(a, c, j, i, kb));
                L.sx[q] = s;
                L.ex[q] += s;
            }
            if (i < nx) {
                const int q = j * nx + i;
                const float res = skip_apply ? L.ry[q] : L.ry[q] - L.ay[q];
                const float s = cheb_step(k, c1, c2, L.sy[q], res,
                                          stencil_dvy(a, c, j, i, kb));
                L.sy[q] = s;
                L.ey[q] += s;
            }
        }
        __syncthreads();  // every update precedes the next application
    }
}

// P^T / 4 of the fine level's emitted residual (F.ax, F.ay) into the
// coarse right-hand side (C.rx, C.ry): solvers/mg.py restrict_vx/_vy.
__device__ void restrict_level(const CoarseParams& P, const CoarseLevel& F,
                               const CoarseLevel& C) {
    const int NY = C.ny, NX = C.nx, fW = F.nx + 1, fny = F.ny, fnx = F.nx;
    const float* fx = F.ax;
    const float* fy = F.ay;
    float* rx = const_cast<float*>(C.rx);
    float* ry = const_cast<float*>(C.ry);
    for (int p = threadIdx.x; p < (NY + 1) * (NX + 1); p += NT) {
        const int J = p / (NX + 1), I = p % (NX + 1);
        if (J < NY) {
            float v = 0.0f;
            if (I != 0 && I != NX) {
                float g[3];
                for (int t = 0; t < 3; ++t) {
                    const int col = 2 * I - 1 + t;
                    const float up = (J == 0) ? P.s_top * fx[col]
                                              : fx[(2 * J - 1) * fW + col];
                    const float dn = (2 * J + 2 == fny)
                                         ? P.s_bottom * fx[(fny - 1) * fW + col]
                                         : fx[(2 * J + 2) * fW + col];
                    g[t] = (0.25f * up + 0.75f * fx[2 * J * fW + col]
                            + 0.75f * fx[(2 * J + 1) * fW + col] + 0.25f * dn)
                           / 2.0f;
                }
                v = (0.5f * g[0] + 1.0f * g[1] + 0.5f * g[2]) / 2.0f;
            }
            rx[J * (NX + 1) + I] = v;
        }
        if (I < NX) {
            float v = 0.0f;
            if (J != 0 && J != NY) {
                float g[3];
                for (int t = 0; t < 3; ++t) {
                    const float* row = fy + (2 * J - 1 + t) * fnx;
                    const float lf = (I == 0) ? P.s_left * row[0] : row[2 * I - 1];
                    const float rt = (2 * I + 2 == fnx) ? P.s_right * row[fnx - 1]
                                                        : row[2 * I + 2];
                    g[t] = (0.25f * lf + 0.75f * row[2 * I] + 0.75f * row[2 * I + 1]
                            + 0.25f * rt) / 2.0f;
                }
                v = (0.5f * g[0] + 1.0f * g[1] + 0.5f * g[2]) / 2.0f;
            }
            ry[J * NX + I] = v;
        }
    }
}

// coarse vx correction, bilinear along y at coarse column I (zero on the
// Dirichlet columns); fine row j
__device__ __forceinline__ float prolong_col_x(const CoarseParams& P,
                                               const CoarseLevel& C, int j,
                                               int I) {
    if (I == 0 || I == C.nx) return 0.0f;
    const int J = j >> 1, W = C.nx + 1;
    const float* c = C.ex;
    const float mid = c[J * W + I];
    if ((j & 1) == 0) {
        const float up = (J == 0) ? P.s_top * c[I] : c[(J - 1) * W + I];
        return 0.25f * up + 0.75f * mid;
    }
    const float dn = (J == C.ny - 1) ? P.s_bottom * mid : c[(J + 1) * W + I];
    return 0.75f * mid + 0.25f * dn;
}

// coarse vy correction, bilinear along x at coarse row J (zero on the
// Dirichlet rows); fine column i
__device__ __forceinline__ float prolong_row_y(const CoarseParams& P,
                                               const CoarseLevel& C, int J,
                                               int i) {
    if (J == 0 || J == C.ny) return 0.0f;
    const int I = i >> 1, NX = C.nx;
    const float* c = C.ey + J * NX;
    const float mid = c[I];
    if ((i & 1) == 0) {
        const float lf = (I == 0) ? P.s_left * c[0] : c[I - 1];
        return 0.25f * lf + 0.75f * mid;
    }
    const float rt = (I == NX - 1) ? P.s_right * mid : c[I + 1];
    return 0.75f * mid + 0.25f * rt;
}

// F.e += P C.e: solvers/mg.py prolong_vx/_vy
__device__ void prolong_add(const CoarseParams& P, const CoarseLevel& C,
                            const CoarseLevel& F) {
    const int ny = F.ny, nx = F.nx, W = nx + 1;
    for (int p = threadIdx.x; p < (ny + 1) * W; p += NT) {
        const int j = p / W, i = p % W;
        if (j < ny && i != 0 && i != nx) {
            const int I = i >> 1;
            const float v = (i & 1) ? 0.5f * (prolong_col_x(P, C, j, I)
                                              + prolong_col_x(P, C, j, I + 1))
                                    : prolong_col_x(P, C, j, I);
            F.ex[j * W + i] = F.ex[j * W + i] + v;
        }
        if (i < nx && j != 0 && j != ny) {
            const int J = j >> 1;
            const float v = (j & 1) ? 0.5f * (prolong_row_y(P, C, J, i)
                                              + prolong_row_y(P, C, J + 1, i))
                                    : prolong_row_y(P, C, J, i);
            F.ey[j * nx + i] = F.ey[j * nx + i] + v;
        }
    }
}

__global__ void __launch_bounds__(NT)
coarse_vcycle_kernel(CoarseParams P, const float* __restrict__ coeffs,
                     const float* __restrict__ kbnds) {
    const int n = P.nlev;
    for (int l = 0; l + 1 < n; ++l) {
        // pre-smooth from zero + the restriction-input residual
        level_sweep(P, P.lv[l], coeffs + 2 * l * P.maxit, kbnds[l], P.pre,
                    true, true);
        restrict_level(P, P.lv[l], P.lv[l + 1]);
        __syncthreads();
    }
    level_sweep(P, P.lv[n - 1], coeffs + 2 * (n - 1) * P.maxit, kbnds[n - 1],
                P.coarse_iters, true, false);
    for (int l = n - 2; l >= 0; --l) {
        prolong_add(P, P.lv[l + 1], P.lv[l]);
        __syncthreads();
        level_sweep(P, P.lv[l], coeffs + 2 * l * P.maxit, kbnds[l], P.post,
                    false, false);
    }
}

}  // namespace

PYLAMP_EXPORT int launch_coarse_vcycle(const CoarseLevel* levels, int nlev,
                                       const float* rx, const float* ry,
                                       float* ex, float* ey,
                                       const float* coeffs,
                                       const float* kbnds, int maxit, int pre,
                                       int post, int coarse_iters,
                                       float s_top, float s_bottom,
                                       float s_left, float s_right,
                                       cudaStream_t stream) {
    if (nlev < 2 || nlev > MAXLEV || maxit < pre || maxit < post
        || maxit < coarse_iters || pre < 1 || post < 1 || coarse_iters < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    CoarseParams P;
    for (int l = 0; l < nlev; ++l) P.lv[l] = levels[l];
    P.lv[0].rx = rx;
    P.lv[0].ry = ry;
    P.lv[0].ex = ex;
    P.lv[0].ey = ey;
    P.nlev = nlev;
    P.maxit = maxit;
    P.pre = pre;
    P.post = post;
    P.coarse_iters = coarse_iters;
    P.s_top = s_top;
    P.s_bottom = s_bottom;
    P.s_left = s_left;
    P.s_right = s_right;
    coarse_vcycle_kernel<<<1, NT, 0, stream>>>(P, coeffs, kbnds);
    return launch_status();
}
