// Fused multi-iteration Chebyshev momentum smoother: `iters` coupled
// Chebyshev iterations of D^-1 A over [lam/4, lam] in one launch, and
// optionally the residual (rx - A ex', ry - A ey') of the final iterate.
//
// Replaces: pylamp_tpu/ops/pallas/cheb_kernel.py:chebyshev_smooth_pallas
// (with prep_smoother_eta), including the vy wall row ny that the TPU
// wrapper updated outside its kernel.
//
// Bound on the H100: memory and launches.  The plain sweep is ~12 full-
// field passes per iteration plus one launch per tensor operation
// (~150 launches for a degree-4 sweep with its residual).  This kernel
// reads ex, ey, rx, ry, eta_s, eta_n once and writes ex', ey' (and the
// residual) once: at 1024^2 ~6 x 4.2 MB read (x ~1.7 for the halo
// overlap at h = 5) and 2-4 x 4.2 MB written.
//
// Design: 2-D temporal blocking.  A block owns a TY x TX tile of the
// (ny+1, nx+1) point space (cheb_sweep.cuh) and loads it with a halo of h
// points on every side into shared memory (ex, ey, eta_s, eta_n: four
// planes).  Every stencil reads only the 3x3 points around its own, so
// after m operator applications the outermost m rings of the loaded
// region are stale and the central tile stays exact while m <= h
// (h = iters, +1 with the emitted residual: the deep-halo argument of
// cheb_kernel.py, in 2-D where the TPU blocked rows only).  The
// pointwise recurrence state (dxs, dys), the residual inputs and the
// Jacobi diagonals stay in registers; only the centre is written back.
// Wall ghosts are resolved inline from current values and the Dirichlet
// lines evolve pointwise, so domain edges never go stale.  The
// coefficient table and kbnd come from device memory (no host sync).
#include "common.cuh"
#include "cheb_sweep.cuh"

namespace {

constexpr int TX = 32;        // centre tile: points per row
constexpr int TY = 32;        // centre tile: rows
constexpr int NT = 256;       // threads per block
constexpr int MAX_H = 7;      // deepest fused sweep (cheb.py MAX_DEPTH)
constexpr int MAXQ = ((TY + 2 * MAX_H) * (TX + 2 * MAX_H) + NT - 1) / NT;

struct SharedAcc {
    const float* ex;
    const float* ey;
    const float* es_;
    const float* en_;
    int j0, i0, LX;  // global point (j0, i0) sits at local (0, 0)
    __device__ __forceinline__ int at(int j, int i) const {
        return (j - j0) * LX + (i - i0);
    }
    __device__ __forceinline__ float vx(int j, int i) const { return ex[at(j, i)]; }
    __device__ __forceinline__ float vy(int j, int i) const { return ey[at(j, i)]; }
    __device__ __forceinline__ float es(int j, int i) const { return es_[at(j, i)]; }
    __device__ __forceinline__ float en(int j, int i) const { return en_[at(j, i)]; }
};

__global__ void __launch_bounds__(NT)
cheb_kernel(const float* __restrict__ ex, const float* __restrict__ ey,
            const float* __restrict__ rx, const float* __restrict__ ry,
            const float* __restrict__ eta_s, const float* __restrict__ eta_n,
            const float* __restrict__ coeffs, const float* __restrict__ kbp,
            float* __restrict__ ox, float* __restrict__ oy,
            float* __restrict__ fx, float* __restrict__ fy, StencilCtx c,
            int iters, int h, int zero_init, int emit) {
    extern __shared__ float smem[];
    const int LX = TX + 2 * h, LY = TY + 2 * h, npts = LX * LY;
    float* s_ex = smem;
    float* s_ey = s_ex + npts;
    float* s_es = s_ey + npts;
    float* s_en = s_es + npts;
    const int ny = c.ny, nx = c.nx;
    const int j0 = blockIdx.y * TY - h;  // global point of local (0, 0)
    const int i0 = blockIdx.x * TX - h;
    const int tid = threadIdx.x;
    const float kb = kbp[0];

    for (int p = tid; p < npts; p += NT) {
        const int gj = j0 + p / LX, gi = i0 + p % LX;
        const bool in_j = gj >= 0 && gj <= ny, in_i = gi >= 0 && gi <= nx;
        const bool has_x = in_i && gj >= 0 && gj < ny;
        const bool has_y = in_j && gi >= 0 && gi < nx;
        s_ex[p] = (has_x && !zero_init) ? ex[gj * (nx + 1) + gi] : 0.0f;
        s_ey[p] = (has_y && !zero_init) ? ey[gj * nx + gi] : 0.0f;
        s_es[p] = (in_j && in_i) ? eta_s[gj * (nx + 1) + gi] : 0.0f;
        s_en[p] = (has_x && has_y) ? eta_n[gj * nx + gi] : 0.0f;
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
                         && li <= LX - 2;
        st_x[q] = st_y[q] = a_x[q] = a_y[q] = 0.0f;
        r_x[q] = r_y[q] = 0.0f;
        d_x[q] = d_y[q] = 1.0f;
        if (act && gj >= 0 && gj < ny && gi >= 0 && gi <= nx) {
            r_x[q] = rx[gj * (nx + 1) + gi];
            d_x[q] = stencil_dvx(a, c, gj, gi, kb);
        }
        if (act && gj >= 0 && gj <= ny && gi >= 0 && gi < nx) {
            r_y[q] = ry[gj * nx + gi];
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
                                 && li >= 1 && li <= LX - 2;
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
                             && li <= LX - 2;
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
        if (p >= npts || lj < h || lj >= h + TY || li < h || li >= h + TX)
            continue;
        if (gj < ny && gi <= nx) {
            ox[gj * (nx + 1) + gi] = s_ex[p];
            if (emit) fx[gj * (nx + 1) + gi] = r_x[q] - a_x[q];
        }
        if (gj <= ny && gi < nx) {
            oy[gj * nx + gi] = s_ey[p];
            if (emit) fy[gj * nx + gi] = r_y[q] - a_y[q];
        }
    }
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
                              int emit, cudaStream_t stream) {
    if (h < 1 || h > MAX_H || iters < 1 || iters + (emit ? 1 : 0) > h)
        return static_cast<int>(cudaErrorInvalidValue);
    const int LX = TX + 2 * h, LY = TY + 2 * h;
    const size_t smem = 4 * sizeof(float) * LX * LY;
    // the deepest halo's planes, set once (under the 48 KB default at
    // MAX_H = 7 with these tiles; kept so a larger tile needs no change)
    static const cudaError_t attr = cudaFuncSetAttribute(
        cheb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(4 * sizeof(float) * (TX + 2 * MAX_H) * (TY + 2 * MAX_H)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    StencilCtx c{ny, nx, dx, dy, s_top, s_bottom, s_left, s_right};
    dim3 grid((nx + 1 + TX - 1) / TX, (ny + 1 + TY - 1) / TY);
    cheb_kernel<<<grid, NT, smem, stream>>>(ex, ey, rx, ry, eta_s, eta_n,
                                            coeffs, kb, ox, oy, fx, fy, c,
                                            iters, h, zero_init, emit);
    return launch_status();
}
