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
// Design: the 2-D temporally blocked tile sweep of cheb_sweep.cuh (shared
// with the per-shard sweep of cheb_block.cu) over the global arrays: a
// block owns a TY x TX tile of the (ny+1, nx+1) point space and loads it
// with a halo of h points.  The coefficient table and kbnd come from
// device memory (no host sync).
#include "common.cuh"
#include "cheb_sweep.cuh"

namespace {

using cheb_tile::MAX_H;
using cheb_tile::NT;
using cheb_tile::TX;
using cheb_tile::TY;

// the level's global row-major arrays
struct GlobalSrc {
    const float* ex_;
    const float* ey_;
    const float* rx_;
    const float* ry_;
    const float* es_;
    const float* en_;
    float* ox;
    float* oy;
    float* fx;
    float* fy;
    int nx, emit;
    __device__ __forceinline__ float ex(int j, int i) const { return ex_[j * (nx + 1) + i]; }
    __device__ __forceinline__ float ey(int j, int i) const { return ey_[j * nx + i]; }
    __device__ __forceinline__ float rx(int j, int i) const { return rx_[j * (nx + 1) + i]; }
    __device__ __forceinline__ float ry(int j, int i) const { return ry_[j * nx + i]; }
    __device__ __forceinline__ float es(int j, int i) const { return es_[j * (nx + 1) + i]; }
    __device__ __forceinline__ float en(int j, int i) const { return en_[j * nx + i]; }
    __device__ __forceinline__ bool inside(int, int) const { return true; }
    __device__ __forceinline__ bool owns(int, int) const { return true; }
    __device__ __forceinline__ void put_x(int j, int i, float e, float f) const {
        ox[j * (nx + 1) + i] = e;
        if (emit) fx[j * (nx + 1) + i] = f;
    }
    __device__ __forceinline__ void put_y(int j, int i, float e, float f) const {
        oy[j * nx + i] = e;
        if (emit) fy[j * nx + i] = f;
    }
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
    const GlobalSrc src{ex, ey, rx, ry, eta_s, eta_n, ox, oy, fx, fy, c.nx,
                        emit};
    // global point of local (0, 0)
    const int j0 = blockIdx.y * TY - h;
    const int i0 = blockIdx.x * TX - h;
    cheb_tile::sweep(src, c, smem, j0, i0, h, coeffs, kbp[0], iters,
                     zero_init, emit);
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
    const size_t smem = cheb_tile::smem_bytes(h);
    // the deepest halo's planes, set once (under the 48 KB default at
    // MAX_H = 7 with these tiles; kept so a larger tile needs no change)
    static const cudaError_t attr = cudaFuncSetAttribute(
        cheb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(cheb_tile::smem_bytes(MAX_H)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    StencilCtx c{ny, nx, dx, dy, s_top, s_bottom, s_left, s_right};
    dim3 grid((nx + 1 + TX - 1) / TX, (ny + 1 + TY - 1) / TY);
    cheb_kernel<<<grid, NT, smem, stream>>>(ex, ey, rx, ry, eta_s, eta_n,
                                            coeffs, kb, ox, oy, fx, fy, c,
                                            iters, h, zero_init, emit);
    return launch_status();
}
