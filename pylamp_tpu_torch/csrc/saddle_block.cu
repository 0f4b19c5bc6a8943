// Per-shard saddle stencil on one-deep extended blocks, all shards of the
// in-process mesh in one launch: (rx, ry, rc) on each shard's interior, or
// the momentum-only form (rx, ry) without p.
//
// Replaces: pylamp_tpu/ops/pallas/block_stencil_kernel.py:saddle_block_pallas.
//
// Bound on the H100: memory.  Per shard at FK 1024^2 on the 4x2 mesh
// (256x512 blocks) it reads vx, vy, p, en (4 x 258 x 514) and es (257 x
// 513) floats and writes 3 x 256 x 512: ~3.2 MB a shard, 26 MB over the
// 8 shards, ~8 us at 3.35 TB/s, against ~30 flops per output point.
//
// Design: one thread per interior point of one shard (blockIdx.z = shard),
// the arithmetic of stencil.cuh (kernel 1's first form).  The
// shard body of parallel/halo_ops.py has already put the BC ghosts into the
// halo ring and applies the Dirichlet patches afterwards, so the accessor
// below shifts block-local indices by one: the stencil's wall tests (index
// 0 or n) never fire and every read lands in the extended block.  kcont
// comes from device memory (no host sync).
#include "common.cuh"
#include "stencil.cuh"

namespace {

// logical (j, i) = block-local (row, col) + 1: vx / vy / en / p at extended
// row j, col i; corner (J, I) at es_ext row J - 1, col I - 1
struct BlockAcc {
    const float* vx_;
    const float* vy_;
    const float* es_;
    const float* en_;
    int W;   // bx + 2: row stride of the (by+2, bx+2) blocks
    int WE;  // bx + 1: row stride of es_ext
    __device__ __forceinline__ float vx(int j, int i) const { return vx_[j * W + i]; }
    __device__ __forceinline__ float vy(int j, int i) const { return vy_[j * W + i]; }
    __device__ __forceinline__ float en(int j, int i) const { return en_[j * W + i]; }
    __device__ __forceinline__ float es(int j, int i) const {
        return es_[(j - 1) * WE + (i - 1)];
    }
};

// no wall is ever reached in logical indices (the ghosts are in the ring)
constexpr int kFar = 1 << 30;

__global__ void saddle_block_kernel(const float* __restrict__ vx,
                                    const float* __restrict__ vy,
                                    const float* __restrict__ p,
                                    const float* __restrict__ es,
                                    const float* __restrict__ en,
                                    const float* __restrict__ kc,
                                    float* __restrict__ rx,
                                    float* __restrict__ ry,
                                    float* __restrict__ rc, int by, int bx,
                                    float dx, float dy) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int r = blockIdx.y * blockDim.y + threadIdx.y;
    const int s = blockIdx.z;
    if (c >= bx || r >= by) return;
    const int W = bx + 2;
    const long long ext = static_cast<long long>(s) * (by + 2) * W;
    const long long ees = static_cast<long long>(s) * (by + 1) * (bx + 1);
    const BlockAcc a{vx + ext, vy + ext, es + ees, en + ext, W, bx + 1};
    const StencilCtx ctx{kFar, kFar, dx, dy, 1.0f, 1.0f, 1.0f, 1.0f};
    const int j = r + 1, i = c + 1;
    const long long o = (static_cast<long long>(s) * by + r) * bx + c;

    float fx = stencil_ax(a, ctx, j, i, 0.0f);
    float fy = stencil_ay(a, ctx, j, i, 0.0f);
    if (p != nullptr) {
        const float* ps = p + ext;
        fx = fx + (ps[j * W + i] - ps[j * W + i - 1]) / dx;
        fy = fy + (ps[j * W + i] - ps[(j - 1) * W + i]) / dy;
        const float dvxdx = (a.vx(j, i + 1) - a.vx(j, i)) / dx;
        const float dvydy = (a.vy(j + 1, i) - a.vy(j, i)) / dy;
        rc[o] = kc[0] * (dvxdx + dvydy);
    }
    rx[o] = fx;
    ry[o] = fy;
}

}  // namespace

PYLAMP_EXPORT int launch_saddle_block(const float* vx, const float* vy,
                                      const float* p, const float* es,
                                      const float* en, const float* kc,
                                      float* rx, float* ry, float* rc, int S,
                                      int by, int bx, float dx, float dy,
                                      cudaStream_t stream) {
    dim3 block(32, 8);
    dim3 grid((bx + block.x - 1) / block.x, (by + block.y - 1) / block.y, S);
    saddle_block_kernel<<<grid, block, 0, stream>>>(vx, vy, p, es, en, kc, rx,
                                                    ry, rc, by, bx, dx, dy);
    return launch_status();
}
