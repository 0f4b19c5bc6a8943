// The tiled RK4 on live slots, one body for two kernels: the single-device
// advection on the global (ny, nx, K) buckets (kernel 3, advect.cu; walls
// and periodic side walls) and the per-shard advection on the exchanged
// velocity windows of every shard of the in-process mesh (kernel 11,
// advect_block.cu).  advect.cu's header describes the design (a tile of
// cells a block, the tile's window of the ghost-padded velocity lattices
// staged in shared memory once, lanes on live slots through a list in
// shared memory, one marker's RK4 each, advect_rk4.cuh's rk4_marker).
// A kernel tells the body where a tile's slots and velocities lie:
//   - Tile: its first cell (global), its extent, and the cell index of its
//     first slot in the marker streams with their row stride;
//   - two Planes: where padded node (r, c) of vx_p and of vy_p lies in
//     device memory, if anywhere (the whole lattice, its wrapped columns,
//     or a shard's window; the window in shared memory is 0 elsewhere).
// The lattices' clamps and the marker's cell are always global, so a
// marker's new position is the same in both kernels wherever the staged
// nodes that its shift window reaches hold the same values.
#pragma once

#include "common.cuh"
#include "advect_rk4.cuh"

namespace advect_tile {

// threads per block; 5 blocks per SM (at most 51 registers a thread)
constexpr int NT = 256;
constexpr int MARGIN = 3;   // window nodes beyond the tile on each side
// columns of wrap padding on each side of a periodic plane (>= the
// largest stage reach + 1); markers/kernels/advect.py PADW
constexpr int PADW = 3;

// Shared-memory layout (bytes); markers/kernels/advect.py smem_bytes
// mirrors it: the two velocity windows ((ty + 2 MARGIN) x (tx + 2 MARGIN)
// floats each), then a list of cap live slots (x, y f32 and the slot's
// code, 12 bytes each).
struct Layout {
    int WH, WW, win, list_x, list_y, list_code, total;
    __host__ __device__ Layout(int ty, int tx, int cap) {
        WH = ty + 2 * MARGIN;
        WW = tx + 2 * MARGIN;
        win = WH * WW;
        list_x = 2 * win;
        list_y = list_x + cap;
        list_code = list_y + cap;
        total = 4 * (list_code + cap);
    }
};

// The markers, the global grid and the plan of a launch
struct AdvectArgs {
    const float* x;
    const float* y;
    const unsigned char* valid;
    const float* dt;
    float* out_x;
    float* out_y;
    int ny, nx, K, ty, tx, cap, reach;
    float dx, dy, x_lo, x_hi, y_lo, y_hi, lx, inv_lx;
    float inv_dx, inv_dy;  // 1 / dx, 1 / dy rounded to nearest (div_rn)
};

// A velocity plane in device memory: padded node (r, c) at f[(r - r0) ld
// + c - c0] for r - r0 in [0, rows) and c - c0 in [0, cols)
struct Plane {
    const float* f;
    int rows, cols, r0, c0, ld;
    __device__ __forceinline__ float at(int r, int c) const {
        const int i = r - r0, j = c - c0;
        return i >= 0 && i < rows && j >= 0 && j < cols ? f[i * ld + j]
                                                        : 0.0f;
    }
};

// A tile: first cell (cj0, ci0) (global), tye x txe cells; the slot s of
// its cell (lr, lci) at (cell0 + lr ld + lci) K + s in the marker streams
struct Tile {
    int cj0, ci0, tye, txe, cell0, ld;
};

// a live slot's code in the list: tile row, tile column, slot
constexpr int SLOT_BITS = 11, COL_BITS = 11;
__device__ __forceinline__ unsigned pack_slot(int lr, int lci, int s) {
    return static_cast<unsigned>(lr) << (SLOT_BITS + COL_BITS) |
           static_cast<unsigned>(lci) << SLOT_BITS |
           static_cast<unsigned>(s);
}

// The plan's check of a launcher
inline bool plan_ok(int K, int ty, int tx, int cap) {
    return K >= 1 && K < (1 << SLOT_BITS) && ty >= 1 && ty <= 256 &&
           tx >= 1 && tx < (1 << COL_BITS) && cap >= NT && cap % NT == 0;
}

// The RK4 of one tile (every thread of the block; the block's shared
// memory is Layout(a.ty, a.tx, a.cap).total dynamic bytes)
template <bool P>
__device__ __forceinline__ void tile_rk4(const AdvectArgs& a,
                                         const Plane& pvx, const Plane& pvy,
                                         const Tile& t) {
    extern __shared__ __align__(16) float sm[];
    __shared__ int n_live;
    const Layout L(a.ty, a.tx, a.cap);
    const int cj0 = t.cj0, ci0 = t.ci0, txe = t.txe, tye = t.tye;
    float* wvx = sm;
    float* wvy = sm + L.win;
    float* list_x = sm + L.list_x;
    float* list_y = sm + L.list_y;
    unsigned* list_code = reinterpret_cast<unsigned*>(sm + L.list_code);

    // the window: padded node (r0 + wr, c0 + wc) at wr * WW + wc
    const int r0 = cj0 - MARGIN, c0 = ci0 - MARGIN;
    for (int i = threadIdx.x; i < L.win; i += NT) {
        const int wr = i / L.WW, wc = i - wr * L.WW;
        wvx[i] = pvx.at(r0 + wr, c0 + wc);
        wvy[i] = pvy.at(r0 + wr, c0 + wc);
    }
    const float dt = *a.dt;
    const Lattice vxl{wvx, a.ny + 2, a.nx + 1, r0, c0, L.WW};
    const Lattice vyl{wvy, a.ny + 1, a.nx + 2, r0, c0, L.WW};

    // this thread's walk over the tile's slots e = lr * txe K + lci K + s,
    // from e = threadIdx.x in steps of NT
    const int K = a.K, row_len = txe * K, n_slots = tye * row_len;
    int lr = threadIdx.x / row_len;
    int lci = (threadIdx.x - lr * row_len) / K;
    int s = threadIdx.x - lr * row_len - lci * K;
    const int dlr = NT / row_len, dlci = (NT - dlr * row_len) / K;
    const int ds = NT - dlr * row_len - dlci * K;
    const unsigned lane = threadIdx.x & 31;
    for (int base = 0; base < n_slots; base += a.cap) {
        const int hi = min(base + a.cap, n_slots);
        if (threadIdx.x == 0) n_live = 0;
        __syncthreads();  // (the window too, before the first round)
        for (int e0 = base; e0 < hi; e0 += NT) {
            bool live = false;
            float px = 0.0f, py = 0.0f;
            if (e0 + static_cast<int>(threadIdx.x) < hi) {
                const long long q =
                    static_cast<long long>(t.cell0 + lr * t.ld + lci) * K + s;
                px = a.x[q];
                py = a.y[q];
                live = a.valid[q] != 0;
                if (!live)
                    rk4_empty<P>(px, py, dt, a.x_lo, a.x_hi, a.y_lo, a.y_hi,
                                 a.out_x[q], a.out_y[q], a.lx, a.inv_lx);
            }
            const unsigned ballot = __ballot_sync(0xffffffffu, live);
            int at = 0;
            if (lane == 0 && ballot) at = atomicAdd(&n_live, __popc(ballot));
            at = __shfl_sync(0xffffffffu, at, 0) +
                 __popc(ballot & ((1u << lane) - 1u));
            if (live) {
                list_x[at] = px;
                list_y[at] = py;
                list_code[at] = pack_slot(lr, lci, s);
            }
            lr += dlr;
            lci += dlci;
            s += ds;
            if (s >= K) {
                s -= K;
                ++lci;
            }
            if (lci >= txe) {
                lci -= txe;
                ++lr;
            }
        }
        __syncthreads();
        const int n = n_live;
        for (int i = threadIdx.x; i < n; i += NT) {
            const unsigned code = list_code[i];
            const int r = static_cast<int>(code >> (SLOT_BITS + COL_BITS));
            const int c = static_cast<int>(code >> SLOT_BITS) &
                          ((1 << COL_BITS) - 1);
            const int cs = static_cast<int>(code) & ((1 << SLOT_BITS) - 1);
            const long long q =
                static_cast<long long>(t.cell0 + r * t.ld + c) * K + cs;
            rk4_marker<P>(list_x[i], list_y[i], cj0 + r, ci0 + c, dt,
                          vxl, vyl, a.dx, a.dy, a.inv_dx, a.inv_dy, a.x_lo,
                          a.x_hi, a.y_lo, a.y_hi, a.reach, a.out_x[q],
                          a.out_y[q], a.lx, a.inv_lx);
        }
        __syncthreads();  // the list is free for the next round
    }
}

// Occupancy of kernel fn at tiles of ty x tx cells and rounds of cap
// slots: out = {registers per thread, static shared bytes, local (spill)
// bytes per thread, resident blocks per SM, threads per block, dynamic
// shared bytes}
inline int kernel_info(const void* fn, int ty, int tx, int cap, int* out) {
    if (!plan_ok(1, ty, tx, cap))
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = Layout(ty, tx, cap).total;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
    out[5] = smem;
    return 0;
}

}  // namespace advect_tile
