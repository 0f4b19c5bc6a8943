// Fused marker -> grid transfer: every per-step stream of the interp and
// energy phases in one pass over the (ny, nx, K) bucketed markers.
//
// Replaces: pylamp_tpu/markers/pallas/m2g_kernel.py:m2g_fused_pallas.
//
// Bound on the H100: memory.  At 1024^2 x K18 (18.9 M slots) it reads the
// five marker streams once (x, y, T f32, mat i32, valid u8: 321 MB) and
// writes 9 node planes of ~1 M floats (38 MB): ~0.36 GB, ~0.11 ms at
// 3.35 TB/s.  Per marker: four divisions, one expf (+ one logf for
// geometric averaging), and ~13 weighted sums into each node it reaches.
//
// Design: a row-streamed gather in shared memory (the (ny, nx, K) layout
// every marker kernel shares stays).
//   - A block owns a strip of TX node columns over a chunk of ROWS node
//     rows (markers/kernels/m2g.py m2g_plan: TX = 32, ROWS = 32).  It
//     streams the strip's cell rows, with one halo cell on each side, top
//     to bottom through a ring of RING = 3 units in shared memory; a unit
//     is one cell row's slots [s0, s0 + KC) of each of its TX + 2 cells
//     (K in balanced units of KC <= 16 slots: two of 9 at K18).  A cell's
//     run of slots is contiguous, so the cp.async loads coalesce (x, y, T,
//     mat 4 bytes a thread, the one-byte valid stream as the aligned words
//     that hold it); unit u + 2 is in flight while unit u + 1 is staged
//     and unit u gathered, one barrier a unit.  Periodic (P): the strip at
//     the seam loads its halo column from the opposite edge, as kernel
//     4's P form does.
//   - Staging, one lane per slot, into one 32-byte record a slot (two
//     16-byte loads for a node thread): each valid marker's properties
//     once (eta after the averaging transform, rho; T and the material for
//     the energy streams, whose material terms come from the table in
//     shared memory, one 16-byte load a material), and its lattice
//     interval (first node as an offset from its cell, and the fraction)
//     on both axes for the corner kind and the center kind, by the same
//     expressions as the plain version (expf and logf, no fast math:
//     m2g_node.cuh interval / marker_props; x / dx correctly rounded by
//     common.cuh div_rn).  A marker reaches the node at offset (a, b) from
//     its cell on some lattice iff a is in its y set (the two node rows of
//     its corner-kind or of its center-kind interval) and b in its x set,
//     so each cell keeps 3 + 3 slot masks, built by warp ballots.
//   - Gather: three thread groups, one per node row J = r - 1, r, r + 1
//     of the unit's cell row r (J mod 3 picks the group), SPLIT = 2
//     threads a node.  A node's thread h walks its three cells (columns I
//     - 1, I, I + 1) and in each the slots s = h mod 2 in both masks of
//     its offset, lowest first, summing w and w v of every stream in
//     registers over the node's three cell rows; the two partial sums then
//     add (one shuffle: both lanes get the same bits).  A node's order is
//     fixed -- cell rows, units, cell columns, slots ascending, per half
//     -- and slots whose weights are all zero add nothing.  No
//     floating-point atomics: one writer per node and a fixed order keep
//     the result deterministic (the reference is bitwise deterministic by
//     design).  A finished node row is written with contiguous stores.
//     The output is the same raw weighted-sum dict as the TPU kernel, so
//     the caller's division step is shared.
//   - Periodic side walls (P): the column-0 thread also writes the seam
//     column nx of the corner and vx lattices, so both seam columns carry
//     the one seam sum.
//   - The rho0 * alpha corner stream (flag WITH_RA, with the energy
//     streams; the RA instantiations) is one more register accumulator of
//     the same gather, written like c_H, the seam column included.
// Measured on an H100 (PERF.md, kernel_probe.py): the unit's fixed work
// -- its barrier, copies and staging -- and the latency of a unit's
// staging, not bytes or arithmetic, set the time; 4 blocks of 6 warps per
// SM (at most 80 registers).
#include <cstdint>

#include "common.cuh"
#include "m2g_node.cuh"

namespace {

constexpr int RING = 3;      // units in shared memory
// threads a block: 3 TX split (TX node columns, split threads a node)
constexpr int MAX_THREADS = 192;
// the streams cp.async lands (one array of S words each)
enum Stream { S_X, S_Y, S_T, S_MAT, N_STREAM };

// A staged slot: one 32-byte record, read by a node thread with two
// 16-byte loads: the fractions of its four intervals, then eta, rho, T and
// the packed interval offsets and material (as float bits)
struct __align__(16) Record {
    float4 t;  // tyc, txc, tyn, txn
    float4 v;  // eta, rho, T, packed
};

// Shared-memory layout (bytes) of one ring buffer for strips of tx node
// columns (tx + 2 cells) and units of kc slots per cell; RING of them.
// markers/kernels/m2g.py smem_bytes mirrors it.  A cell's slots sit at a
// stride KP = kc | 1 (odd: node threads reading the same slot of
// neighbouring cells spread over the banks): the streams x, y, T, mat as
// arrays of S slots (the cp.async targets), the records (32 bytes a
// slot), then per cell VW words of valid bytes (up to 3 bytes of
// alignment lead) and 6 masks (y offsets -1, 0, 1; x offsets -1, 0, 1);
// a buffer's size is a multiple of 16 bytes.
struct Layout {
    int cells, KP, S, VW, rec, valid, masks, buf, total;
    __host__ __device__ Layout(int tx, int kc) {
        cells = tx + 2;
        KP = kc | 1;
        S = cells * KP;
        VW = (kc + 6) / 4;
        rec = 4 * N_STREAM * S;
        valid = rec + static_cast<int>(sizeof(Record)) * S;
        masks = valid + 4 * VW * cells;
        buf = (masks + 24 * cells + 15) / 16 * 16;  // records stay aligned
        total = RING * buf;
    }
};

struct M2GArgs {
    const float* x;
    const float* y;
    const float* T;
    const int* mat;
    const unsigned char* valid;
    M2GOut out;
    int ny, nx, K, tx, rows, kc, nchunks, split, flags;
    float dx, dy;
    float inv_dx, inv_dy;  // 1 / dx, 1 / dy rounded to nearest (div_rn)
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait0() {
    asm volatile("cp.async.wait_group 0;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::);
}

// The stored column of local cell lc (global column i0 - 1 + lc) of a
// strip with txe node columns, or -1 where the strip needs no such cell
// or a wall has none.
template <bool P>
__device__ __forceinline__ int cell_col(int lc, int i0, int txe, int nx) {
    if (lc > txe + 1) return -1;
    const int cu = i0 - 1 + lc;
    if (P) return cu < 0 ? cu + nx : (cu >= nx ? cu - nx : cu);
    return cu < nx && cu >= 0 ? cu : -1;
}

// A flat walk over the slots e of a unit's cells, with the cell lc and
// slot s of each, stepped without a division (made once per thread)
struct SlotWalk {
    int lc, s, dlc, ds;
    __device__ SlotWalk(int kc) {
        lc = threadIdx.x / kc;
        s = threadIdx.x - lc * kc;
        dlc = blockDim.x / kc;
        ds = blockDim.x - dlc * kc;
    }
    __device__ __forceinline__ void next(int kc) {
        lc += dlc;
        s += ds;
        if (s >= kc) {
            s -= kc;
            ++lc;
        }
    }
};

// A unit of a block: its cell row r, its slots [s0, s0 + kc) of each
// cell; units follow each other by next() (no division)
struct Unit {
    int r, s0, kc;
    __device__ __forceinline__ Unit next(const M2GArgs& a) const {
        const int t = s0 + a.kc;
        return t < a.K ? Unit{r, t, min(a.kc, a.K - t)}
                       : Unit{r + 1, 0, min(a.kc, a.K)};
    }
    // the first slot of the unit's run in cell column col (the wrapper
    // keeps ny nx K below 2^31)
    __device__ __forceinline__ int first(const M2GArgs& a, int col) const {
        return (r * a.nx + col) * a.K + s0;
    }
};

// the offset of a run's first valid byte within its first aligned word
__device__ __forceinline__ int lead_of(const unsigned char* p, int q) {
    return static_cast<int>(
        (static_cast<unsigned>(reinterpret_cast<uintptr_t>(p)) +
         static_cast<unsigned>(q)) & 3u);
}

// cp.async of unit u (its TX + 2 cells' runs) into its ring buffer;
// commits one group whether or not the unit exists
template <bool P>
__device__ void copy_unit(const M2GArgs& a, unsigned char* smem,
                          const Layout& L, const SlotWalk& walk, int i0,
                          int txe, const Unit& un, bool exists, int u) {
    if (exists) {
        unsigned char* b = smem + (u % RING) * L.buf;
        float* W = reinterpret_cast<float*>(b);
        SlotWalk w = walk;
        for (int e = threadIdx.x; e < L.cells * a.kc;
             e += blockDim.x, w.next(a.kc)) {
            if (w.s >= un.kc) continue;
            const int col = cell_col<P>(w.lc, i0, txe, a.nx);
            if (col < 0) continue;
            const int q = un.first(a, col) + w.s;
            const int d = w.lc * L.KP + w.s;
            cp_async4(W + S_X * L.S + d, a.x + q);
            cp_async4(W + S_Y * L.S + d, a.y + q);
            cp_async4(W + S_T * L.S + d, a.T + q);
            cp_async4(W + S_MAT * L.S + d, a.mat + q);
        }
        // the valid bytes of each run as the aligned words that hold them
        // (a torch allocation is 512-byte aligned and sized, so those
        // words lie inside it)
        for (int v = threadIdx.x; v < L.cells * L.VW; v += blockDim.x) {
            const int lc = v / L.VW, wi = v - lc * L.VW;
            const int col = cell_col<P>(lc, i0, txe, a.nx);
            if (col < 0) continue;
            const int q = un.first(a, col);
            if (wi >= (lead_of(a.valid, q) + un.kc + 3) >> 2) continue;
            const unsigned* w0 = reinterpret_cast<const unsigned*>(
                reinterpret_cast<uintptr_t>(a.valid + q) & ~uintptr_t(3));
            cp_async4(b + L.valid + 4 * v, w0 + wi);
        }
    }
    cp_async_commit();
}

__device__ __forceinline__ void zero_masks(unsigned char* smem,
                                           const Layout& L, int u) {
    unsigned* m =
        reinterpret_cast<unsigned*>(smem + (u % RING) * L.buf + L.masks);
    for (int i = threadIdx.x; i < 6 * L.cells; i += blockDim.x) m[i] = 0u;
}

// node offsets a in {-1, 0, 1} (bit a + 1) that an interval starting at
// offset o from the cell reaches: {o, o + 1}
__device__ __forceinline__ unsigned reach_bits(int o) {
    return (o >= -2 && o <= 1) ? ((3u << (o + 2)) >> 1) & 7u : 0u;
}

// an interval's first node as an offset from the cell, kept in 4 bits:
// offsets outside [-3, 2] reach no node of the 3x3 neighbourhood
__device__ __forceinline__ unsigned pack_offset(int o) {
    return static_cast<unsigned>(min(max(o, -3), 2) + 4);
}
__device__ __forceinline__ int unpack_offset(unsigned pk, int shift) {
    return static_cast<int>((pk >> shift) & 15u) - 4;
}

// Stage unit u in place (arrived and visible, its masks zeroed): each
// valid marker's intervals, properties and mask bits.  The walk is
// warp-uniform: a warp's lanes are consecutive slots, so a cell's bits in
// one warp come from one ballot per mask and go in with one atomicOr (a
// cell spans at most two warps or two steps).
template <bool P>
__device__ void stage_unit(const M2GArgs& a, unsigned char* smem,
                           const Layout& L, const M2GTable& tbl,
                           const SlotWalk& walk, int i0, int txe,
                           const Unit& un, bool exists, int u) {
    if (!exists) return;
    unsigned char* b = smem + (u % RING) * L.buf;
    float* W = reinterpret_cast<float*>(b);
    const unsigned* Wu = reinterpret_cast<const unsigned*>(b);
    Record* rec = reinterpret_cast<Record*>(b + L.rec);
    unsigned* mask = reinterpret_cast<unsigned*>(b + L.masks);
    const float hx = 0.5f * a.dx;  // center-kind origin offsets
    const float hy = 0.5f * a.dy;
    const int lane = threadIdx.x & 31, n_slots = L.cells * a.kc;
    // the lanes of this warp (the block's last warp may be partial)
    const int warp_lanes = min(32, static_cast<int>(blockDim.x) -
                                       static_cast<int>(threadIdx.x & ~31u));
    const unsigned members =
        warp_lanes == 32 ? 0xffffffffu : (1u << warp_lanes) - 1u;
    SlotWalk w = walk;
#pragma unroll 2  // two slots' chains interleave
    for (int e0 = 0; e0 < n_slots; e0 += blockDim.x, w.next(a.kc)) {
        const bool in = e0 + static_cast<int>(threadIdx.x) < n_slots;
        const int col = in ? cell_col<P>(w.lc, i0, txe, a.nx) : -1;
        unsigned ys = 0u, xs = 0u;
        if (col >= 0 && w.s < un.kc &&
            b[L.valid + 4 * L.VW * w.lc + lead_of(a.valid, un.first(a, col)) +
              w.s]) {
            const int d = w.lc * L.KP + w.s;
            const float px = W[S_X * L.S + d];
            const float py = W[S_Y * L.S + d];
            const float Tm = W[S_T * L.S + d];
            const int m =
                material_of(tbl, static_cast<int>(Wu[S_MAT * L.S + d]));
            // corner-kind axes: nodes at cell edges; center-kind: at cell
            // centers (fx = (x - dx/2) / dx)
            const float fxc = div_rn(px - 0.0f, a.dx, a.inv_dx);
            const float fyc = div_rn(py - 0.0f, a.dy, a.inv_dy);
            const float fxn = div_rn(px - hx, a.dx, a.inv_dx);
            const float fyn = div_rn(py - hy, a.dy, a.inv_dy);
            int jc, jn, ic, inn;
            float tyc, tyn, txc, txn;
            interval(fyc, a.ny + 1, jc, tyc);
            interval(fyn, a.ny, jn, tyn);
            if (P) {
                interval_px(fxc, ic, txc);
                interval_px(fxn, inn, txn);
            } else {
                interval(fxc, a.nx + 1, ic, txc);
                interval(fxn, a.nx, inn, txn);
            }
            jc -= un.r;
            jn -= un.r;
            ic -= col;
            inn -= col;
            const MarkerProps pr = marker_props(tbl, m, Tm);
            const unsigned pk = pack_offset(jc) | pack_offset(jn) << 4 |
                                pack_offset(ic) << 8 |
                                pack_offset(inn) << 12 |
                                static_cast<unsigned>(m) << 16;
            rec[d] = Record{make_float4(tyc, txc, tyn, txn),
                            make_float4(pr.eta, pr.rho, Tm,
                                        __uint_as_float(pk))};
            ys = reach_bits(jc) | reach_bits(jn);
            xs = reach_bits(ic) | reach_bits(inn);
        }
        // (a warp with no valid slot has no bits to set)
        if (__ballot_sync(members, (ys | xs) != 0u) == 0u) continue;
        // the first lane of each cell in this warp ORs the cell's bits
        const bool first = in && (w.s == 0 || lane == 0);
        const int cnt = min(a.kc - w.s, 32 - lane);
        const unsigned sel = cnt >= 32 ? ~0u : (1u << cnt) - 1u;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
            const unsigned bits = (k < 3 ? ys >> k : xs >> (k - 3)) & 1u;
            const unsigned ballot = __ballot_sync(members, bits != 0u);
            const unsigned mine = (ballot >> lane) & sel;
            if (first && mine) atomicOr(mask + 6 * w.lc + k, mine << w.s);
        }
    }
}

// The sums of one node thread (m2g_node.cuh's accumulators)
struct Sums {
    float c_w, c_eta, n_w, n_eta, vy_w, vy_rho, vx_w, vx_rho;
    float c_T, c_k, c_rhocp, c_H, c_ra;
};

template <bool P, bool RA>
__global__ void __launch_bounds__(MAX_THREADS, 4)
m2g_kernel(const M2GArgs a, const M2GTable tbl_in) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ M2GTable tbl;
    // per material: k, rho0 * cp, H, rho0 * alpha (one 16-byte load)
    __shared__ float4 terms_of[kMaxMat];
    const int TX = a.tx;
    const Layout L(TX, a.kc);
    const int nxn = P ? a.nx : a.nx + 1;  // node columns the threads own
    const int i0 = blockIdx.x * TX, txe = min(TX, nxn - i0);
    const int j_lo = blockIdx.y * a.rows;
    const int j_hi = min(j_lo + a.rows, a.ny + 1);
    // the chunk's cell rows, each in nchunks units
    const int r_first = max(j_lo - 1, 0), r_last = min(j_hi, a.ny - 1);
    const int n_units = (r_last - r_first + 1) * a.nchunks;
    // this thread: group g (node rows J = g mod 3), node column I, and
    // its share h of the node's slots (those with s mod split = h)
    const int per_group = TX * a.split;
    const int g = threadIdx.x / per_group;
    const int lt = (threadIdx.x - g * per_group) / a.split;
    const int h = threadIdx.x & (a.split - 1);
    const unsigned share = a.split == 1 ? 0xffffffffu : 0x55555555u << h;
    const int I = i0 + lt;
    const bool col_on = lt < txe;
    const bool energy = a.flags & WITH_ENERGY;
    if (threadIdx.x == 0) {
        tbl = tbl_in;
#pragma unroll
        for (int m = 0; m < kMaxMat; ++m) {
            terms_of[m] = make_float4(tbl_in.k[m], tbl_in.rho0[m] * tbl_in.cp[m],
                                      tbl_in.H[m],
                                      tbl_in.rho0[m] * tbl_in.alpha[m]);
        }
    }

    // the prologue: units 0 and 1 in flight, 0 staged
    const SlotWalk walk(a.kc);
    Unit un{r_first, 0, min(a.kc, a.K)};  // unit u
    copy_unit<P>(a, smem, L, walk, i0, txe, un, 0 < n_units, 0);
    copy_unit<P>(a, smem, L, walk, i0, txe, un.next(a), 1 < n_units, 1);
    zero_masks(smem, L, 0);
    zero_masks(smem, L, 1);
    cp_async_wait1();
    __syncthreads();
    stage_unit<P>(a, smem, L, tbl, walk, i0, txe, un, 0 < n_units, 0);

    Sums acc{};
    // this group's node row: J = r - 1 + phase for unit row r
    int phase = ((g - r_first + 1) % 3 + 3) % 3;
    for (int u = 0; u < n_units; ++u, un = un.next(a)) {
        // unit u staged and unit u + 1 arrived everywhere; the buffer of
        // unit u + 2 last held unit u - 1, gathered before this barrier
        cp_async_wait0();
        __syncthreads();
        const Unit un1 = un.next(a);
        copy_unit<P>(a, smem, L, walk, i0, txe, un1.next(a), u + 2 < n_units,
                     u + 2);
        zero_masks(smem, L, u + 2);
        stage_unit<P>(a, smem, L, tbl, walk, i0, txe, un1, u + 1 < n_units,
                      u + 1);

        // gather unit u: this group's node row J of r - 1, r, r + 1
        if (un.s0 == 0 && un.r != r_first) phase = phase == 0 ? 2 : phase - 1;
        const int J = un.r - 1 + phase;
        if (J < j_lo || J >= j_hi) continue;  // (the whole group)
        if (un.s0 == 0 && un.r == max(J - 1, 0)) acc = Sums{};
        const int a_off = J - un.r;  // the node's offset from cell row r
        const bool has_n = (J < a.ny) && (I < a.nx);
        const bool has_vy = I < a.nx;
        const bool has_vx = (J < a.ny) && (a.flags & WITH_VX);
        const unsigned char* b = smem + (u % RING) * L.buf;
        const Record* rec = reinterpret_cast<const Record*>(b + L.rec);
        const unsigned* mask = reinterpret_cast<const unsigned*>(b + L.masks);
#pragma unroll
        for (int cb = 0; cb < 3; ++cb) {  // cell columns I - 1, I, I + 1
            const int lc = lt + cb, b_off = 1 - cb;
            // the slots reaching offset (a, b): y mask a + 1, x mask b + 1
            unsigned hits = col_on ? mask[6 * lc + a_off + 1] &
                                         mask[6 * lc + 5 - cb] & share
                                   : 0u;
            while (hits) {
                const int s = __ffs(hits) - 1;
                hits &= hits - 1u;
                const int d = lc * L.KP + s;
                const float4 rt = rec[d].t, rv = rec[d].v;
                const unsigned pk = __float_as_uint(rv.w);
                const float wyc = hat_weight(a_off, unpack_offset(pk, 0), rt.x);
                const float wxc = hat_weight(b_off, unpack_offset(pk, 8), rt.y);
                const float wyn =
                    has_n || has_vx ? hat_weight(a_off, unpack_offset(pk, 4),
                                                 rt.z)
                                    : 0.0f;
                const float wxn =
                    !has_vy ? 0.0f
                            : hat_weight(b_off, unpack_offset(pk, 12),
                                         rt.w);
                const float w_c = wyc * wxc;
                const float w_n = has_n ? wyn * wxn : 0.0f;
                const float w_vy = has_vy ? wyc * wxn : 0.0f;
                const float w_vx = has_vx ? wyn * wxc : 0.0f;
                const float eta = rv.x;
                const float rho = rv.y;
                acc.c_w += w_c;
                acc.c_eta += w_c * eta;
                acc.n_w += w_n;
                acc.n_eta += w_n * eta;
                acc.vy_w += w_vy;
                acc.vy_rho += w_vy * rho;
                acc.vx_w += w_vx;
                acc.vx_rho += w_vx * rho;
                if (energy) {
                    const int m = static_cast<int>(pk >> 16);
                    const float4 tm = terms_of[m];
                    acc.c_T += w_c * rv.z;
                    acc.c_k += w_c * tm.x;
                    acc.c_rhocp += w_c * tm.y;
                    acc.c_H += w_c * tm.z;
                    if constexpr (RA) acc.c_ra += w_c * tm.w;
                }
            }
        }
        if (un.s0 + un.kc < a.K || un.r != min(J + 1, a.ny - 1)) continue;

        // node (J, I) is complete: its split partial sums combine in a
        // fixed tree (every lane of the node gets the same bits), and its
        // row is written with contiguous stores across the group
        for (int o = 1; o < a.split; o <<= 1) {
            acc.c_w += __shfl_xor_sync(0xffffffffu, acc.c_w, o);
            acc.c_eta += __shfl_xor_sync(0xffffffffu, acc.c_eta, o);
            acc.n_w += __shfl_xor_sync(0xffffffffu, acc.n_w, o);
            acc.n_eta += __shfl_xor_sync(0xffffffffu, acc.n_eta, o);
            acc.vy_w += __shfl_xor_sync(0xffffffffu, acc.vy_w, o);
            acc.vy_rho += __shfl_xor_sync(0xffffffffu, acc.vy_rho, o);
            acc.vx_w += __shfl_xor_sync(0xffffffffu, acc.vx_w, o);
            acc.vx_rho += __shfl_xor_sync(0xffffffffu, acc.vx_rho, o);
            if (energy) {
                acc.c_T += __shfl_xor_sync(0xffffffffu, acc.c_T, o);
                acc.c_k += __shfl_xor_sync(0xffffffffu, acc.c_k, o);
                acc.c_rhocp += __shfl_xor_sync(0xffffffffu, acc.c_rhocp, o);
                acc.c_H += __shfl_xor_sync(0xffffffffu, acc.c_H, o);
                if (RA) acc.c_ra += __shfl_xor_sync(0xffffffffu, acc.c_ra, o);
            }
        }
        if (!col_on || h != 0) continue;
        const M2GOut& out = a.out;
        const long long qc = static_cast<long long>(J) * (a.nx + 1) + I;
        const long long qn = static_cast<long long>(J) * a.nx + I;
        // P: the corner and vx sums of column 0 go to column nx as well
        const bool seam = P && I == 0;
        const long long qs = qc + a.nx;
        out.p[C_W][qc] = acc.c_w;
        out.p[C_ETA][qc] = acc.c_eta;
        if (seam) {
            out.p[C_W][qs] = acc.c_w;
            out.p[C_ETA][qs] = acc.c_eta;
        }
        if (has_n) {
            out.p[N_W][qn] = acc.n_w;
            out.p[N_ETA][qn] = acc.n_eta;
        }
        if (has_vy) {  // vy lattice (ny+1, nx)
            out.p[VY_W][qn] = acc.vy_w;
            out.p[VY_RHO][qn] = acc.vy_rho;
        }
        if (has_vx) {  // vx lattice (ny, nx+1)
            out.p[VX_W][qc] = acc.vx_w;
            out.p[VX_RHO][qc] = acc.vx_rho;
            if (seam) {
                out.p[VX_W][qs] = acc.vx_w;
                out.p[VX_RHO][qs] = acc.vx_rho;
            }
        }
        if (energy) {
            out.p[C_T][qc] = acc.c_T;
            out.p[C_K][qc] = acc.c_k;
            out.p[C_RHOCP][qc] = acc.c_rhocp;
            if (a.flags & WITH_H) out.p[C_H][qc] = acc.c_H;
            if (RA) out.p[C_RA][qc] = acc.c_ra;
            if (seam) {
                out.p[C_T][qs] = acc.c_T;
                out.p[C_K][qs] = acc.c_k;
                out.p[C_RHOCP][qs] = acc.c_rhocp;
                if (a.flags & WITH_H) out.p[C_H][qs] = acc.c_H;
                if (RA) out.p[C_RA][qs] = acc.c_ra;
            }
        }
    }
    asm volatile("cp.async.wait_all;\n" ::);  // (empty groups only)
}

using KernelFn = void (*)(const M2GArgs, const M2GTable);

KernelFn pick(int flags) {
    // RA only with the energy streams, as the wrapper sets it
    const bool ra = (flags & WITH_RA) && (flags & WITH_ENERGY);
    return (flags & PERIODIC) ? (ra ? m2g_kernel<true, true>
                                    : m2g_kernel<true, false>)
                              : (ra ? m2g_kernel<false, true>
                                    : m2g_kernel<false, false>);
}

bool plan_ok(int tx, int kc, int split) {
    return tx >= 1 && kc >= 1 && kc <= 32 && (split == 1 || split == 2) &&
           3 * tx * split <= MAX_THREADS && (tx * split) % 32 == 0;
}

}  // namespace

// tx, rows, kc, nchunks: the strip width, chunk rows and slot units of
// markers/kernels/m2g.py m2g_plan (kc slots a unit, nchunks units a cell
// row: kc * nchunks >= K > kc * (nchunks - 1)).
PYLAMP_EXPORT int launch_m2g(const float* x, const float* y, const float* T,
                             const int* mat, const unsigned char* valid,
                             const void* table, const void* outs, int ny,
                             int nx, int K, float dx, float dy, int flags,
                             int tx, int rows, int kc, int nchunks,
                             int split, cudaStream_t stream) {
    if (ny < 1 || nx < 1 || K < 1 || rows < 1 || !plan_ok(tx, kc, split) ||
        kc * nchunks < K || kc * (nchunks - 1) >= K ||
        static_cast<long long>(ny) * nx * K >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    M2GArgs a{x,  y,  T,  mat, valid, {}, ny, nx, K, tx, rows, kc, nchunks,
              split, flags, dx, dy, 1.0f / dx, 1.0f / dy};
    for (int n = 0; n < N_OUT; ++n)
        a.out.p[n] = static_cast<float* const*>(outs)[n];
    const M2GTable tbl = *static_cast<const M2GTable*>(table);
    const int nxn = (flags & PERIODIC) ? nx : nx + 1;
    const dim3 grid((nxn + tx - 1) / tx, (ny + 1 + rows - 1) / rows);
    const int smem = Layout(tx, kc).total;
    const KernelFn kernel = pick(flags);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, 3 * tx * split, smem, stream>>>(a, tbl);
    return launch_status();
}

// Occupancy of the instantiation that `flags` picks (PERIODIC, WITH_RA
// with WITH_ENERGY) at strips of tx columns and units of kc slots: out =
// {registers per thread, static shared bytes, local (spill) bytes per
// thread, resident blocks per SM, threads per block, dynamic shared
// bytes}.
PYLAMP_EXPORT int m2g_kernel_info(int tx, int kc, int split, int flags,
                                  int* out) {
    if (!plan_ok(tx, kc, split))
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = Layout(tx, kc).total;
    const KernelFn kernel = pick(flags);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(kernel));
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, 3 * tx * split, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = fa.numRegs;
    out[1] = static_cast<int>(fa.sharedSizeBytes);
    out[2] = static_cast<int>(fa.localSizeBytes);
    out[3] = blocks;
    out[4] = 3 * tx * split;
    out[5] = smem;
    return 0;
}
