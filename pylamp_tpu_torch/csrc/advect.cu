// Fused RK4 marker advection in the (ny, nx, K) bucket layout.
//
// Replaces: pylamp_tpu/markers/pallas/advect_kernel.py:advect_rk4_pallas.
//
// Bound on the H100: memory.  At 1024^2 x K18 (18.9 M slots) it reads
// x, y (f32) and valid (u8) -- 170 MB -- and writes the new x, y (151 MB):
// ~0.32 GB, ~0.1 ms at 3.35 TB/s.  Per marker: 32 bilinear reads (4
// stages x 2 lattices x 4 corners), ~16 IEEE divisions, ~200 flops.
//
// Design: a tile of cells a block, its velocities in shared memory and
// its lanes on live slots only.
//   - A block owns a tile of TY x TX cells (markers/kernels/advect.py
//     advect_plan: 3 x 32 at K18).  It stages the tile's window of the
//     ghost-padded lattices vx_p (ny+2, nx+1) and vy_p (ny+1, nx+2) --
//     the tile plus MARGIN = 3 nodes on each side, >= the largest stage
//     reach + 1 -- in shared memory once; every one of a marker's 32
//     samples then reads shared memory (advect_rk4.cuh's Lattice with the
//     window's origin and stride; its shift-window mask keeps every read
//     inside the window).  Periodic side walls (P): the window is cut from
//     the wrapped planes the wrapper builds (advect.py wrapped_planes,
//     PADW columns of wrap on each side), x is not clamped and the new x
//     wraps into [0, lx).
//   - Lanes on live slots: the block walks its tile's slots (each tile
//     row one contiguous run, coalesced loads of x, y and valid) in rounds
//     of at most CAP slots.  An empty slot gets its output at once (its
//     position clipped to the domain, or wrapped: advect_rk4.cuh's
//     rk4_empty, the RK4 with zero velocity, as the plain version's); a
//     valid one is appended to a list in shared memory (one ballot and
//     one shared atomicAdd a warp).  Then every lane takes list entries,
//     one marker's RK4 each.  Each marker's result depends on nothing
//     else, so the list's order does not matter: the output is
//     deterministic.
//   - A slot's cell comes from the tile and a walk stepped without a
//     division; no 64-bit division a slot.
//   - The arithmetic per marker is advect_rk4.cuh's rk4_marker (shared
//     with the per-shard kernel 11) in the same order; its divisions s /
//     dx are common.cuh's div_rn (correctly rounded from 1 / dx, without
//     the division's slow-path call), so the new positions are those of
//     the one-thread-per-slot form.  dt is read from device memory (no
//     host sync).
#include "common.cuh"
#include "advect_rk4.cuh"

namespace {

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

struct AdvectArgs {
    const float* x;
    const float* y;
    const unsigned char* valid;
    const float* vx_p;
    const float* vy_p;
    const float* dt;
    float* out_x;
    float* out_y;
    int ny, nx, K, ty, tx, cap, reach;
    float dx, dy, x_lo, x_hi, y_lo, y_hi, lx, inv_lx;
    float inv_dx, inv_dy;  // 1 / dx, 1 / dy rounded to nearest (div_rn)
};

// a live slot's code in the list: tile row, tile column, slot
constexpr int SLOT_BITS = 11, COL_BITS = 11;
__device__ __forceinline__ unsigned pack_slot(int lr, int lci, int s) {
    return static_cast<unsigned>(lr) << (SLOT_BITS + COL_BITS) |
           static_cast<unsigned>(lci) << SLOT_BITS |
           static_cast<unsigned>(s);
}

template <bool P>
__global__ void __launch_bounds__(NT, 5) advect_kernel(const AdvectArgs a) {
    extern __shared__ __align__(16) float sm[];
    __shared__ int n_live;
    const Layout L(a.ty, a.tx, a.cap);
    const int ci0 = blockIdx.x * a.tx, cj0 = blockIdx.y * a.ty;
    const int txe = min(a.tx, a.nx - ci0), tye = min(a.ty, a.ny - cj0);
    float* wvx = sm;
    float* wvy = sm + L.win;
    float* list_x = sm + L.list_x;
    float* list_y = sm + L.list_y;
    unsigned* list_code = reinterpret_cast<unsigned*>(sm + L.list_code);

    // the window: lattice node (r0 + wr, c0 + wc) at wr * WW + wc
    const int r0 = cj0 - MARGIN, c0 = ci0 - MARGIN;
    for (int i = threadIdx.x; i < L.win; i += NT) {
        const int wr = i / L.WW, wc = i - wr * L.WW;
        const int r = r0 + wr, c = c0 + wc;
        float u = 0.0f, v = 0.0f;
        if (P) {  // planes (ny + 2 | ny + 1, nx + 2 PADW), column c at c + PADW
            const int pw = a.nx + 2 * PADW, pc = c + PADW;
            if (pc >= 0 && pc < pw && r >= 0) {
                if (r < a.ny + 2) u = a.vx_p[r * pw + pc];
                if (r < a.ny + 1) v = a.vy_p[r * pw + pc];
            }
        } else if (r >= 0 && c >= 0) {
            if (r < a.ny + 2 && c < a.nx + 1) u = a.vx_p[r * (a.nx + 1) + c];
            if (r < a.ny + 1 && c < a.nx + 2) v = a.vy_p[r * (a.nx + 2) + c];
        }
        wvx[i] = u;
        wvy[i] = v;
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
                    (static_cast<long long>(cj0 + lr) * a.nx + ci0 + lci) * K +
                    s;
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
                (static_cast<long long>(cj0 + r) * a.nx + ci0 + c) * K + cs;
            rk4_marker<P>(list_x[i], list_y[i], true, cj0 + r, ci0 + c, dt,
                          vxl, vyl, a.dx, a.dy, a.inv_dx, a.inv_dy, a.x_lo,
                          a.x_hi, a.y_lo, a.y_hi, a.reach, a.out_x[q],
                          a.out_y[q], a.lx, a.inv_lx);
        }
        __syncthreads();  // the list is free for the next round
    }
}

template <bool P>
cudaError_t configure(int smem) {
    return cudaFuncSetAttribute(advect_kernel<P>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
}

bool plan_ok(int K, int ty, int tx, int cap) {
    return K >= 1 && K < (1 << SLOT_BITS) && ty >= 1 && ty <= 256 &&
           tx >= 1 && tx < (1 << COL_BITS) && cap >= NT && cap % NT == 0;
}

}  // namespace

// ty, tx, cap: the tile and the slots a round of
// markers/kernels/advect.py advect_plan.
PYLAMP_EXPORT int launch_advect(const float* x, const float* y,
                                const unsigned char* valid, const float* vx_p,
                                const float* vy_p, const float* dt,
                                float* out_x, float* out_y, int ny, int nx,
                                int K, float dx, float dy, float x_lo,
                                float x_hi, float y_lo, float y_hi, int reach,
                                int periodic, float lx, float inv_lx, int ty,
                                int tx, int cap, cudaStream_t stream) {
    if (ny < 1 || nx < 1 || !plan_ok(K, ty, tx, cap))
        return static_cast<int>(cudaErrorInvalidValue);
    const AdvectArgs a{x,    y,    valid, vx_p,  vy_p,  dt,    out_x,
                       out_y, ny,  nx,    K,     ty,    tx,    cap,
                       reach, dx,  dy,    x_lo,  x_hi,  y_lo,  y_hi,
                       lx,   inv_lx, 1.0f / dx, 1.0f / dy};
    const int smem = Layout(ty, tx, cap).total;
    const dim3 grid((nx + tx - 1) / tx, (ny + ty - 1) / ty);
    const cudaError_t err =
        periodic ? configure<true>(smem) : configure<false>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (periodic)
        advect_kernel<true><<<grid, NT, smem, stream>>>(a);
    else
        advect_kernel<false><<<grid, NT, smem, stream>>>(a);
    return launch_status();
}

// Occupancy of the kernel (periodic: its P form) at tiles of ty x tx
// cells and rounds of cap slots: out = {registers per thread, static
// shared bytes, local (spill) bytes per thread, resident blocks per SM,
// threads per block, dynamic shared bytes}.
PYLAMP_EXPORT int advect_kernel_info(int ty, int tx, int cap, int periodic,
                                     int* out) {
    if (!plan_ok(1, ty, tx, cap))
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = Layout(ty, tx, cap).total;
    const void* fn =
        periodic ? reinterpret_cast<const void*>(advect_kernel<true>)
                 : reinterpret_cast<const void*>(advect_kernel<false>);
    cudaError_t err =
        periodic ? configure<true>(smem) : configure<false>(smem);
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
