// Fused multi-iteration Chebyshev smoother on the depth-h halo frames of
// every shard of the in-process mesh, in one launch: `iters` coupled
// Chebyshev iterations of D^-1 A and optionally the residual of the final
// iterate, returned on each shard's central (by, bx) block.
//
// Replaces: pylamp_tpu/ops/pallas/cheb_block_kernel.py:cheb_block_pallas.
//
// Bound on the H100: memory.  Per shard at FK 1024^2 on the 4x2 mesh
// (256x512 blocks, h = 5) it reads six frames of ~266 x 522 floats
// (3.3 MB) and writes 2-4 blocks of 256 x 512 (1-2 MB): ~5 MB a shard,
// ~40 MB over the 8 shards, ~12 us at 3.35 TB/s; ~130 flops per point and
// iteration, far below the f32 peak.
//
// Design: the tile sweep of cheb_sweep.cuh (kernel 5's, shared), pointed
// at a shard's frame instead of the global arrays.  blockIdx.z is the
// shard; its tiles cover the central block.  The frame is addressed in a
// per-shard logical index space in which the shard's PHYSICAL walls sit
// where stencil.cuh expects them (row 0 / ny, column 0 / nx) and every
// other edge lies out of reach: the wall flags (device data, one row per
// shard) choose the offsets.  So the wall ghosts are re-derived from
// current values on every application and the Dirichlet lines inside the
// frame evolve pointwise through the kbnd recurrence, as the reference
// kernel's runtime-flag selects do; the frame's outer h rings are
// sacrificial.  Coefficients and kbnd come from device memory.
#include "common.cuh"
#include "cheb_sweep.cuh"

namespace {

using cheb_tile::MAX_H;
using cheb_tile::NT;
using cheb_tile::TX;
using cheb_tile::TY;

constexpr int kOff = 1 << 20;  // logical origin of a shard without a wall
constexpr int kFar = 1 << 29;  // a wall that is never reached

// One shard's frames: logical point (j, i) sits at frame (j - oy + h,
// i - ox + h); ex/rx (R, C+1), ey/ry (R+1, C), es (R+1, C+1), en (R, C)
// with R = by + 2h, C = bx + 2h; outputs (by, bx).
struct FrameSrc {
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
    int R, C, h, oy0, ox0, by, bx, emit;
    __device__ __forceinline__ float load(const float* a, int rows, int cols,
                                          int j, int i) const {
        const int r = j - oy0 + h, q = i - ox0 + h;
        return (r >= 0 && r < rows && q >= 0 && q < cols) ? a[r * cols + q]
                                                          : 0.0f;
    }
    __device__ __forceinline__ float ex(int j, int i) const { return load(ex_, R, C + 1, j, i); }
    __device__ __forceinline__ float ey(int j, int i) const { return load(ey_, R + 1, C, j, i); }
    __device__ __forceinline__ float rx(int j, int i) const { return load(rx_, R, C + 1, j, i); }
    __device__ __forceinline__ float ry(int j, int i) const { return load(ry_, R + 1, C, j, i); }
    __device__ __forceinline__ float es(int j, int i) const { return load(es_, R + 1, C + 1, j, i); }
    __device__ __forceinline__ float en(int j, int i) const { return load(en_, R, C, j, i); }
    __device__ __forceinline__ bool inside(int j, int i) const {
        const int r = j - oy0 + h, q = i - ox0 + h;
        return r >= 0 && r < R && q >= 0 && q < C;
    }
    __device__ __forceinline__ bool owns(int j, int i) const {
        return j - oy0 >= 0 && j - oy0 < by && i - ox0 >= 0 && i - ox0 < bx;
    }
    __device__ __forceinline__ void put_x(int j, int i, float e, float f) const {
        const int o = (j - oy0) * bx + (i - ox0);
        ox[o] = e;
        if (emit) fx[o] = f;
    }
    __device__ __forceinline__ void put_y(int j, int i, float e, float f) const {
        const int o = (j - oy0) * bx + (i - ox0);
        oy[o] = e;
        if (emit) fy[o] = f;
    }
};

__global__ void __launch_bounds__(NT)
cheb_block_kernel(const float* __restrict__ ex, const float* __restrict__ ey,
                  const float* __restrict__ rx, const float* __restrict__ ry,
                  const float* __restrict__ es, const float* __restrict__ en,
                  const float* __restrict__ flags,
                  const float* __restrict__ coeffs,
                  const float* __restrict__ kbp, float* __restrict__ ox,
                  float* __restrict__ oy, float* __restrict__ fx,
                  float* __restrict__ fy, int by, int bx, int h, float dx,
                  float dy, float s_top, float s_bottom, float s_left,
                  float s_right, int iters, int zero_init, int emit) {
    extern __shared__ float smem[];
    const int s = blockIdx.z;
    const int R = by + 2 * h, C = bx + 2 * h;
    const bool wt = flags[4 * s] > 0.5f, wb = flags[4 * s + 1] > 0.5f;
    const bool wl = flags[4 * s + 2] > 0.5f, wr = flags[4 * s + 3] > 0.5f;
    const int oy0 = wt ? 0 : kOff, ox0 = wl ? 0 : kOff;
    const StencilCtx c{wb ? oy0 + by : kFar, wr ? ox0 + bx : kFar, dx, dy,
                       s_top, s_bottom, s_left, s_right};
    const long long fX = static_cast<long long>(s) * R * (C + 1);
    const long long fY = static_cast<long long>(s) * (R + 1) * C;
    const long long fS = static_cast<long long>(s) * (R + 1) * (C + 1);
    const long long fN = static_cast<long long>(s) * R * C;
    const long long fO = static_cast<long long>(s) * by * bx;
    const FrameSrc src{ex + fX, ey + fY, rx + fX, ry + fY, es + fS, en + fN,
                       ox + fO, oy + fO, fx + fO, fy + fO, R, C, h, oy0, ox0,
                       by, bx, emit};
    const int j0 = oy0 + blockIdx.y * TY - h;  // logical point of local (0, 0)
    const int i0 = ox0 + blockIdx.x * TX - h;
    cheb_tile::sweep(src, c, smem, j0, i0, h, coeffs, kbp[0], iters,
                     zero_init, emit);
}

}  // namespace

PYLAMP_EXPORT int launch_cheb_block(const float* ex, const float* ey,
                                    const float* rx, const float* ry,
                                    const float* es, const float* en,
                                    const float* flags, const float* coeffs,
                                    const float* kb, float* ox, float* oy,
                                    float* fx, float* fy, int S, int by,
                                    int bx, int h, float dx, float dy,
                                    float s_top, float s_bottom, float s_left,
                                    float s_right, int iters, int zero_init,
                                    int emit, cudaStream_t stream) {
    if (h < 1 || h > MAX_H || iters < 1 || iters + (emit ? 1 : 0) > h)
        return static_cast<int>(cudaErrorInvalidValue);
    static const cudaError_t attr = cudaFuncSetAttribute(
        cheb_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(cheb_tile::smem_bytes(MAX_H)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    dim3 grid((bx + TX - 1) / TX, (by + TY - 1) / TY, S);
    cheb_block_kernel<<<grid, NT, cheb_tile::smem_bytes(h), stream>>>(
        ex, ey, rx, ry, es, en, flags, coeffs, kb, ox, oy, fx, fy, by, bx, h,
        dx, dy, s_top, s_bottom, s_left, s_right, iters, zero_init, emit);
    return launch_status();
}
