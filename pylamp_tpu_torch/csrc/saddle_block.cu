// Per-shard saddle stencil on one-deep extended blocks, all shards of the
// in-process mesh in one launch: (rx, ry, rc) on each shard's interior, or
// the momentum-only form (rx, ry) without p.
//
// Replaces: pylamp_tpu/ops/pallas/block_stencil_kernel.py:saddle_block_pallas.
//
// Bound on the H100: memory.  Per shard at FK 1024^2 on the 4x2 mesh
// (256x512 blocks) it reads vx, vy, p, en (4 x 258 x 514) and es (257 x
// 513) floats and writes 3 x 256 x 512: ~3.2 MB a shard, 26 MB over the
// 8 shards, ~8 us at 3.35 TB/s, against ~30 flops per output point (the
// momentum-only form: ~20 MB, ~6 us).
//
// Design: kernel 1's tile (saddle_tile.cuh, the one body of kernels 1, 7
// and 9) on every shard, blockIdx.z the shard.  A block of 32 x 8 threads
// stages a 16 x 32 tile of one shard's points and a one-point ring (vx,
// vy, es, en and p) in shared memory, computes sxy once per corner into a
// shared plane and forms the rows with SweepConsts' reciprocals (kernel
// 1's reassociation: a few f32 units in the last place against the plain
// version's divisions; the bar is 1e-5 of max |ref|).
//   - Index space: logical point (j, i), j in 1..by, i in 1..bx, is
//     extended (j, i) of vx, vy, en and p (row stride bx + 2), es_ext
//     (j - 1, i - 1) (stride bx + 1) and output (j - 1, i - 1) (stride
//     bx); each plane's pointer is shifted to that origin and to its
//     shard.
//   - No wall logic: the shard body of parallel/halo_ops.py has already
//     put the BC ghosts into the halo ring and patches the Dirichlet rows
//     afterwards, so every point has all its rows and the frame of a full
//     tile lies inside the extended blocks.  Full tiles (all of them at
//     the mesh's 256x512 blocks) take the branch-free form; the ragged
//     last row and column of tiles of odd shapes bound their loads and
//     stores only.  es_ext has no row or column at logical 0: the tile
//     never stages the frame's ring row and column 0 of es, which no
//     corner reads.
//   - kcont comes from device memory (no host sync); the momentum-only
//     form is the PR = false instantiation (no p plane, no continuity).
#include "common.cuh"
#include "saddle_tile.cuh"

namespace {

using namespace saddle_tile;

// the elements of one shard's extended (by+2, bx+2) block, es_ext (by+1,
// bx+1) and (by, bx) output
struct ShardSizes {
    long long ext, es, out;
};

template <class T>
__device__ __forceinline__ Plane<T> shard(Plane<T> p, long long n) {
    p.a += static_cast<long long>(blockIdx.z) * n;
    return p;
}

template <bool PR>
__global__ void __launch_bounds__(NT)
saddle_block_kernel(const Fields f0, const SweepConsts c, const ShardSizes z) {
    __shared__ Planes<PR> s;
    Fields f = f0;
    f.vx = shard(f0.vx, z.ext);
    f.vy = shard(f0.vy, z.ext);
    f.en = shard(f0.en, z.ext);
    f.es = shard(f0.es, z.es);
    f.rx = shard(f0.rx, z.out);
    f.ry = shard(f0.ry, z.out);
    if constexpr (PR) {
        f.p = shard(f0.p, z.ext);
        f.rc = shard(f0.rc, z.out);
    }
    apply_block_tile<PR>(s, f, c);
}

}  // namespace

// p == nullptr: the momentum-only form (rc and kc are not read).
PYLAMP_EXPORT int launch_saddle_block(const float* vx, const float* vy,
                                      const float* p, const float* es,
                                      const float* en, const float* kc,
                                      float* rx, float* ry, float* rc, int S,
                                      int by, int bx, float dx, float dy,
                                      cudaStream_t stream) {
    if (S < 1 || by < 1 || bx < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const SweepConsts c = sweep_consts(by, bx, dx, dy, 1.0f, 1.0f, 1.0f,
                                       1.0f);
    const int W = bx + 2, WE = bx + 1;
    // logical (j, i) = extended (j, i) = es_ext and output (j - 1, i - 1)
    const Fields f{{vx, W}, {vy, W}, {es - WE - 1, WE}, {en, W}, {p, W},
                   nullptr, kc, {rx - bx - 1, bx}, {ry - bx - 1, bx},
                   {p ? rc - bx - 1 : nullptr, bx}};
    const ShardSizes z{static_cast<long long>(by + 2) * W,
                       static_cast<long long>(by + 1) * WE,
                       static_cast<long long>(by) * bx};
    const dim3 block(TX, BY), grid = block_tile_grid(S, by, bx);
    if (p)
        saddle_block_kernel<true><<<grid, block, 0, stream>>>(f, c, z);
    else
        saddle_block_kernel<false><<<grid, block, 0, stream>>>(f, c, z);
    return launch_status();
}

// Occupancy of the kernel (with_p: the form with p): out as
// saddle_kernel_info's.
PYLAMP_EXPORT int saddle_block_kernel_info(int with_p, int* out) {
    return kernel_info(
        with_p ? reinterpret_cast<const void*>(saddle_block_kernel<true>)
               : reinterpret_cast<const void*>(saddle_block_kernel<false>),
        out);
}
