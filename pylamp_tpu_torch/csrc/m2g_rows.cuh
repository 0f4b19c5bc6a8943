// The row-streamed marker -> grid gather, one body for two kernels: the
// single-device transfer on the global (ny, nx, K) buckets (kernel 2,
// m2g.cu; walls and periodic side walls) and the per-shard transfer on
// the one-ring-extended marker blocks of every shard of the in-process
// mesh (kernel 10, m2g_block.cu).  m2g.cu's header describes the design
// (a strip of TX node columns over a chunk of node rows; the strip's cell
// rows, one halo cell on each side, streamed through a ring of RING slot
// units in shared memory by cp.async; each valid marker staged once into
// a 32-byte record with its slot-mask bits; SPLIT threads a node summing
// the slots of its 3 x 3 cells in a fixed order; one writer per node).
// A kernel tells the body where a block's cells and nodes lie:
//   - Block: the block's global node rows and columns, and the global cell
//     rows and columns its marker array holds (the walls for kernel 2;
//     for kernel 10 also the shard's ring, so a frame node on the ring's
//     edge completes at the ring's last cell row or column with the
//     partial sum of the cells that the ring holds; P: the columns
//     unwrapped, -1 .. nx for kernel 2p, the ring for kernel 10p; a
//     marker's interval counts from the column its cell wraps to);
//   - Cells::first(r, col): the first slot of global cell (r, col) in the
//     marker streams, col unwrapped (31-bit: the launchers refuse larger
//     arrays);
//   - Sink::put: where a complete node's sums go.
// Intervals and slot offsets always use the global lattice and the global
// cell, so the same markers give the same sums in the same order in both
// kernels.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "m2g_node.cuh"

namespace m2g_rows {

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

// The streams, the global grid and the plan of a launch
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

// A block's work: its node columns i0 .. i0 + txe - 1 and node rows
// j_lo .. j_hi - 1, and the cell rows r_lo .. r_hi and cell columns
// c_lo .. c_hi that its marker array holds (global; P: unwrapped)
struct Block {
    int i0, txe, j_lo, j_hi, r_lo, r_hi, c_lo, c_hi;
};

// The plan's check of a launcher: strips of tx columns, 3 tx split
// threads in whole warps, units of at most one mask word
inline bool plan_ok(int tx, int kc, int split) {
    return tx >= 1 && kc >= 1 && kc <= 32 && (split == 1 || split == 2) &&
           3 * tx * split <= MAX_THREADS && (tx * split) % 32 == 0;
}

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

// no cell: cell_col's answer where there is none (a column no block holds)
constexpr int NO_CELL = -(1 << 30);

// The global column of local cell lc (column i0 - 1 + lc) of a block's
// strip, unwrapped (P: -1 and nx at the ends of the period), or NO_CELL
// where the strip needs no such cell or the array has none.
// Cells::first takes the column as it is (kernel 2p's GlobalCells wraps
// it; a shard's ring holds it unwrapped)
__device__ __forceinline__ int cell_col(int lc, const Block& b) {
    if (lc > b.txe + 1) return NO_CELL;
    const int cu = b.i0 - 1 + lc;
    return cu <= b.c_hi && cu >= b.c_lo ? cu : NO_CELL;
}

// The column a marker's x interval is counted from: the cell's column
// wrapped into the period (P), where the marker's x lies
template <bool P>
__device__ __forceinline__ int wrapped(int col, int nx) {
    return P ? (col < 0 ? col + nx : (col >= nx ? col - nx : col)) : col;
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
    // the first slot of the unit's run in cell column col
    template <class Cells>
    __device__ __forceinline__ int first(const Cells& cells, int col) const {
        return cells.first(r, col) + s0;
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
template <bool P, class Cells>
__device__ void copy_unit(const M2GArgs& a, const Cells& cells,
                          unsigned char* smem, const Layout& L,
                          const SlotWalk& walk, const Block& blk,
                          const Unit& un, bool exists, int u) {
    if (exists) {
        unsigned char* b = smem + (u % RING) * L.buf;
        float* W = reinterpret_cast<float*>(b);
        SlotWalk w = walk;
        for (int e = threadIdx.x; e < L.cells * a.kc;
             e += blockDim.x, w.next(a.kc)) {
            if (w.s >= un.kc) continue;
            const int col = cell_col(w.lc, blk);
            if (col == NO_CELL) continue;
            const int q = un.first(cells, col) + w.s;
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
            const int col = cell_col(lc, blk);
            if (col == NO_CELL) continue;
            const int q = un.first(cells, col);
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
template <bool P, class Cells>
__device__ void stage_unit(const M2GArgs& a, const Cells& cells,
                           unsigned char* smem, const Layout& L,
                           const M2GTable& tbl, const SlotWalk& walk,
                           const Block& blk, const Unit& un, bool exists,
                           int u) {
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
        const int col = in ? cell_col(w.lc, blk) : NO_CELL;
        unsigned ys = 0u, xs = 0u;
        if (col != NO_CELL && w.s < un.kc &&
            b[L.valid + 4 * L.VW * w.lc +
              lead_of(a.valid, un.first(cells, col)) + w.s]) {
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
            ic -= wrapped<P>(col, a.nx);
            inn -= wrapped<P>(col, a.nx);
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

// The sums of one node thread, in m2g_node.cuh's Out order
struct Sums {
    float c_w, c_eta, n_w, n_eta, vy_w, vy_rho, vx_w, vx_rho;
    float c_T, c_k, c_rhocp, c_H, c_ra;
};

// The gather of one block (every thread of it; the block's shared memory
// is Layout(a.tx, a.kc).total dynamic bytes).  Sink::put<P, RA>(a, J, I,
// acc, has_n, has_vy, has_vx) stores complete node (J, I) from the
// node's h = 0 thread.
template <bool P, bool RA, class Cells, class Sink>
__device__ __forceinline__ void gather_rows(const M2GArgs& a,
                                            const M2GTable& tbl_in,
                                            const Cells& cells,
                                            const Sink& out,
                                            const Block& blk) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ M2GTable tbl;
    // per material: k, rho0 * cp, H, rho0 * alpha (one 16-byte load)
    __shared__ float4 terms_of[kMaxMat];
    const int TX = a.tx;
    const Layout L(TX, a.kc);
    const int i0 = blk.i0, txe = blk.txe;
    const int j_lo = blk.j_lo, j_hi = blk.j_hi;
    // the chunk's cell rows, each in nchunks units
    const int r_first = max(j_lo - 1, blk.r_lo), r_last = min(j_hi, blk.r_hi);
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
    copy_unit<P>(a, cells, smem, L, walk, blk, un, 0 < n_units, 0);
    copy_unit<P>(a, cells, smem, L, walk, blk, un.next(a), 1 < n_units, 1);
    zero_masks(smem, L, 0);
    zero_masks(smem, L, 1);
    cp_async_wait1();
    __syncthreads();
    stage_unit<P>(a, cells, smem, L, tbl, walk, blk, un, 0 < n_units, 0);

    Sums acc{};
    // this group's node row: J = r - 1 + phase for unit row r
    int phase = ((g - r_first + 1) % 3 + 3) % 3;
    for (int u = 0; u < n_units; ++u, un = un.next(a)) {
        // unit u staged and unit u + 1 arrived everywhere; the buffer of
        // unit u + 2 last held unit u - 1, gathered before this barrier
        cp_async_wait0();
        __syncthreads();
        const Unit un1 = un.next(a);
        copy_unit<P>(a, cells, smem, L, walk, blk, un1.next(a),
                     u + 2 < n_units, u + 2);
        zero_masks(smem, L, u + 2);
        stage_unit<P>(a, cells, smem, L, tbl, walk, blk, un1,
                      u + 1 < n_units, u + 1);

        // gather unit u: this group's node row J of r - 1, r, r + 1
        if (un.s0 == 0 && un.r != r_first) phase = phase == 0 ? 2 : phase - 1;
        const int J = un.r - 1 + phase;
        if (J < j_lo || J >= j_hi) continue;  // (the whole group)
        if (un.s0 == 0 && un.r == max(J - 1, blk.r_lo)) acc = Sums{};
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
        if (un.s0 + un.kc < a.K || un.r != min(J + 1, blk.r_hi)) continue;

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
        out.template put<P, RA>(a, J, I, acc, has_n, has_vy, has_vx);
    }
    asm volatile("cp.async.wait_all;\n" ::);  // (empty groups only)
}

// Occupancy of kernel fn at strips of tx columns, units of kc slots and
// split threads a node: out = {registers per thread, static shared bytes,
// local (spill) bytes per thread, resident blocks per SM, threads per
// block, dynamic shared bytes}
inline int kernel_info(const void* fn, int tx, int kc, int split, int* out) {
    if (!plan_ok(tx, kc, split))
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = Layout(tx, kc).total, threads = 3 * tx * split;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = fa.numRegs;
    out[1] = static_cast<int>(fa.sharedSizeBytes);
    out[2] = static_cast<int>(fa.localSizeBytes);
    out[3] = blocks;
    out[4] = threads;
    out[5] = smem;
    return 0;
}

}  // namespace m2g_rows
