// The row-streamed repack, one body for two kernels: the single-device
// rebucket on the global (ny, nx, K) buckets (kernel 4, rebucket.cu; both
// wall forms, a drop count) and the per-shard rebucket on the one-ring-
// extended marker blocks of every shard of the in-process mesh (kernel 12,
// rebucket_block.cu; the arrivals of every target).  rebucket.cu's header
// describes the design (a strip of TX target columns over a chunk of
// target rows, walked with a ring of RING source rows in shared memory
// loaded by cp.async; each slot's target coded once per ring row with its
// bit in its cell's target mask; insertion offsets from popc of the
// masks in the reference's order; one scatter per row into an output row
// in shared memory, stored contiguously).  A kernel tells the body where
// a block's cells lie (Block): the source and output CellMaps and the
// block's global target rows and columns.  Codes always use the global
// cell (sj, si) and the global clip to (ny, nx).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace rebucket_rows {

constexpr int NT = 256;  // threads per block
constexpr int NWARPS = NT / 32;
constexpr int RING = 4;  // source rows in shared memory
constexpr unsigned char NONE = 255;  // a slot bound for no target

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Shared-memory layout (bytes) for strips of tx columns and K slots per
// cell; markers/kernels/rebucket.py smem_bytes mirrors it.  A ring row:
// x, y, T, mat (S = (tx + 2) K words each), the 9 target masks of each
// cell (KW = ceil(K / 32) words each), the counts of its slots bound for
// the row above and the row below, and the valid bytes of the left
// halo, the strip and the right halo (each an aligned superset: up to 3
// bytes of lead), which the codes overwrite.  Then the output row (tx K
// words of x, y, T, mat), the 9 insertion offsets of each target (ints),
// the bucket counts (tx ints) and the per-warp drop sums.
struct Layout {
    int S, KW, mask, movers, v0, v1, v2, row, out, off, counts, red, total;
    __host__ __device__ Layout(int tx, int K) {
        S = (tx + 2) * K;
        KW = (K + 31) / 32;
        mask = 16 * S;
        movers = mask + 36 * KW * (tx + 2);
        v0 = movers + 8;
        v1 = v0 + round4(K + 3);
        v2 = v1 + round4(tx * K + 3);
        row = v2 + round4(K + 3);
        out = RING * row;
        off = out + 16 * tx * K;
        counts = off + 36 * tx;
        red = counts + 4 * tx;
        total = red + 4 * NWARPS;
    }
};

// The streams, the grid and the plan of a launch.  dropped: kernel 4's
// drop count (one int64 it adds to); arrivals: kernel 12's arrivals per
// target cell.
struct RebucketArgs {
    const float* x;
    const float* y;
    const float* T;
    const int* mat;
    const unsigned char* valid;
    float* ox;
    float* oy;
    float* oT;
    int* omat;
    unsigned char* ovalid;
    unsigned long long* dropped;
    int* arrivals;
    int ny, nx, K, tx, rows;
    float dx, dy;
};

// Where global cell (sj, col) lies in an array of cells of row stride
// ld: cell index off + sj ld + col, its first slot K times that (off
// folds in the array's origin: -(row0 ld + col0) for an array whose first
// cell is global (row0, col0), plus the cells before it).  period > 0 (a
// shard's ring across a periodic x seam, kernel 12p): col is wrapped into
// [0, period) and lies in the array at col0 + ((col - col0) shifted by the
// period into [0, ld)); with one shard a row the ring's columns hold the
// shard's own edge columns, so either copy reads the same markers.
struct CellMap {
    long long off;
    int ld;
    int col0 = 0, period = 0;
    __device__ __forceinline__ long long cell(int sj, int col) const {
        if (period) {
            const int l = col - col0;
            col += l < 0 ? period : (l >= ld ? -period : 0);
        }
        return off + static_cast<long long>(sj) * ld + col;
    }
};

// A block's work: its target rows j_lo..j_hi-1 and columns i0..i0+txe-1
// (global), where its source cells and its output cells lie
struct Block {
    CellMap src, dst;
    int i0, txe, j_lo, j_hi;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::);
}

// The strip's halo columns: the global column of the left (local column
// 0) and right (local column txe + 1) halo, or -1 where a wall has none.
__device__ __forceinline__ int left_halo(int i0, int nx, bool P) {
    return i0 > 0 ? i0 - 1 : (P ? nx - 1 : -1);
}
__device__ __forceinline__ int right_halo(int i0, int txe, int nx, bool P) {
    return i0 + txe < nx ? i0 + txe : (P ? 0 : -1);
}

// cp.async of n slots of source row sj from global column col onward into
// the ring row at byte offset rb, local slot l, with the valid bytes as
// the aligned words that hold them into the staging at byte offset vb (a
// torch allocation is 512-byte aligned and sized, so those words lie
// inside it)
__device__ __forceinline__ void copy_run(const RebucketArgs& a,
                                         const CellMap& src,
                                         unsigned char* smem,
                                         const Layout& L, int rb, int vb,
                                         int sj, int col, int l, int n) {
    const long long g = src.cell(sj, col) * a.K;
    float* f = reinterpret_cast<float*>(smem + rb);
    for (int e = threadIdx.x; e < n; e += NT) {
        cp_async4(f + l + e, a.x + g + e);
        cp_async4(f + L.S + l + e, a.y + g + e);
        cp_async4(f + 2 * L.S + l + e, a.T + g + e);
        cp_async4(f + 3 * L.S + l + e, a.mat + g + e);
    }
    const uintptr_t s = reinterpret_cast<uintptr_t>(a.valid + g);
    const unsigned* w0 = reinterpret_cast<const unsigned*>(s & ~uintptr_t(3));
    const int words = (static_cast<int>(s & 3) + n + 3) >> 2;
    for (int w = threadIdx.x; w < words; w += NT)
        cp_async4(smem + vb + 4 * w, w0 + w);
}

// Source row sj of the strip into its ring row (slot sj mod RING): the
// left halo, the strip and the right halo.  Commits one group whether or
// not the row exists.
template <bool P>
__device__ __forceinline__ void copy_row(const RebucketArgs& a,
                                         const Block& b, unsigned char* smem,
                                         const Layout& L, int sj) {
    if (sj >= 0 && sj < a.ny) {
        const int rb = (sj & (RING - 1)) * L.row, K = a.K;
        const int lh = left_halo(b.i0, a.nx, P);
        const int rh = right_halo(b.i0, b.txe, a.nx, P);
        if (lh >= 0) copy_run(a, b.src, smem, L, rb, rb + L.v0, sj, lh, 0, K);
        copy_run(a, b.src, smem, L, rb, rb + L.v1, sj, b.i0, K, b.txe * K);
        if (rh >= 0)
            copy_run(a, b.src, smem, L, rb, rb + L.v2, sj, rh,
                     (b.txe + 1) * K, K);
    }
    cp_async_commit();
}

// Where the valid byte (and then the code) of slot e = lc K + s of ring
// row sj lies: base(lc) + e, with base per run (the left halo, the strip,
// the right halo) from the lead bytes of the run's first slot's address
struct CodeBase {
    int b0, b1, b2;
    __device__ CodeBase(const RebucketArgs& a, const Block& b,
                        const Layout& L, int rb, int sj, int lh, int rh) {
        const unsigned v = static_cast<unsigned>(
            reinterpret_cast<uintptr_t>(a.valid));
        const unsigned K = a.K;
        auto lead = [&](int col) {
            return static_cast<int>(
                (v + static_cast<unsigned>(b.src.cell(sj, col)) * K) & 3u);
        };
        b0 = rb + L.v0 + lead(max(lh, 0));
        b1 = rb + L.v1 + lead(b.i0) - a.K;
        b2 = rb + L.v2 + lead(max(rh, 0)) - (b.txe + 1) * a.K;
    }
    __device__ __forceinline__ int at(int lc, int txe) const {
        return lc == 0 ? b0 : (lc <= txe ? b1 : b2);
    }
};

// A flat walk over the slots e of txe + 2 cells with the cell lc and slot
// s of each, stepped without a division
struct SlotWalk {
    int lc, s, dlc, ds;
    __device__ SlotWalk(int K) {
        lc = threadIdx.x / K;
        s = threadIdx.x - lc * K;
        dlc = NT / K;
        ds = NT - dlc * K;
    }
    __device__ __forceinline__ void next(int K) {
        lc += dlc;
        s += ds;
        if (s >= K) {
            s -= K;
            ++lc;
        }
    }
};

// Ring row sj (arrived and visible, its masks and movers zeroed): each
// slot's code, written over its valid byte, its bit in its cell's target
// mask, and the row's count of slots bound for the row above or below
template <bool P>
__device__ __forceinline__ void code_row(const RebucketArgs& a,
                                         const Block& b, unsigned char* smem,
                                         const Layout& L, int sj) {
    const int rb = (sj & (RING - 1)) * L.row, K = a.K;
    const int i0 = b.i0, txe = b.txe;
    const float* f = reinterpret_cast<const float*>(smem + rb);
    unsigned* mask = reinterpret_cast<unsigned*>(smem + rb + L.mask);
    unsigned* movers = reinterpret_cast<unsigned*>(smem + rb + L.movers);
    const int lh = left_halo(i0, a.nx, P);
    const int rh = right_halo(i0, txe, a.nx, P);
    const CodeBase cb(a, b, L, rb, sj, lh, rh);
    SlotWalk w(K);
    for (int e = threadIdx.x; e < (txe + 2) * K; e += NT, w.next(K)) {
        const int si = w.lc == 0 ? lh : (w.lc <= txe ? i0 + w.lc - 1 : rh);
        unsigned char* c = smem + cb.at(w.lc, txe) + e;
        int code = NONE;
        if (si >= 0 && *c) {
            const int ti = min(max(static_cast<int>(f[e] / a.dx), 0),
                               a.nx - 1);
            const int tj = min(max(static_cast<int>(f[L.S + e] / a.dy), 0),
                               a.ny - 1);
            const int dj = tj - sj;
            int di = ti - si;
            if (P) di = di == a.nx - 1 ? -1 : (di == 1 - a.nx ? 1 : di);
            if (dj >= -1 && dj <= 1 && di >= -1 && di <= 1) {
                code = (dj + 1) * 3 + di + 1;
                atomicOr(mask + (9 * w.lc + code) * L.KW + (w.s >> 5),
                         1u << (w.s & 31));
                if (dj != 0) atomicAdd(movers + (dj > 0), 1u);
            }
        }
        *c = static_cast<unsigned char>(code);
    }
}

// slots of cell lc sent to target code c: all of them (s = K), or those
// below slot s (its rank)
__device__ __forceinline__ int mask_count(const unsigned* mask,
                                          const Layout& L, int lc, int c,
                                          int s) {
    const unsigned* m = mask + (9 * lc + c) * L.KW;
    int n = 0;
    for (int w = 0; w < (s >> 5); ++w) n += __popc(m[w]);
    if (s & 31) n += __popc(m[s >> 5] & ((1u << (s & 31)) - 1u));
    return n;
}

// The repack of one block (smem: L.total dynamic bytes).  ARR: every
// target's arrivals go to a.arrivals at its output cell (kernel 12); else
// the block's overflow drops are added to a.dropped (kernel 4).
template <bool P, bool ARR>
__device__ __forceinline__ void repack(const RebucketArgs& a, const Block& b,
                                       unsigned char* smem) {
    const int K = a.K;
    const Layout L(a.tx, K);
    const int i0 = b.i0, txe = b.txe, j_lo = b.j_lo, j_hi = b.j_hi;
    const int lh = left_halo(i0, a.nx, P);
    const int rh = right_halo(i0, txe, a.nx, P);
    // the output row: x, y, T, mat of tx K slots; the insertion offsets
    // of each target's 9 sources; the bucket counts
    float* out = reinterpret_cast<float*>(smem + L.out);
    const int TK = a.tx * K;
    int* omat = reinterpret_cast<int*>(out + 3 * TK);
    int* off = reinterpret_cast<int*>(smem + L.off);
    int* counts = reinterpret_cast<int*>(smem + L.counts);
    int drops = 0;  // threads of the targets

    // the masks and movers of ring row sj zeroed (its slot last served
    // target row sj - 3, done before the barrier that ended its scatter)
    auto zero_row = [&](int sj) {
        unsigned char* r = smem + (sj & (RING - 1)) * L.row;
        unsigned* m = reinterpret_cast<unsigned*>(r + L.mask);
        for (int i = threadIdx.x; i < 9 * L.KW * (txe + 2); i += NT) m[i] = 0u;
        if (threadIdx.x < 2)
            reinterpret_cast<unsigned*>(r + L.movers)[threadIdx.x] = 0u;
    };
    // slots of ring row sj's cell lc bound for target code c
    auto count = [&](int sj, int lc, int c) {
        return mask_count(reinterpret_cast<const unsigned*>(
                              smem + (sj & (RING - 1)) * L.row + L.mask),
                          L, lc, c, K);
    };
    // the prologue: rows j_lo - 1 and j_lo coded, j_lo + 1 in flight
    copy_row<P>(a, b, smem, L, j_lo - 1);
    copy_row<P>(a, b, smem, L, j_lo);
    copy_row<P>(a, b, smem, L, j_lo + 1);
    zero_row(j_lo - 1);
    zero_row(j_lo);
    cp_async_wait1();
    __syncthreads();
    if (j_lo > 0) code_row<P>(a, b, smem, L, j_lo - 1);
    code_row<P>(a, b, smem, L, j_lo);
    for (int cj = j_lo; cj < j_hi; ++cj) {
        // the slot of row cj + 2 held row cj - 2, last read by target row
        // cj - 1 before the barrier that ended its scatter; row j_hi is
        // the chunk's last source row
        copy_row<P>(a, b, smem, L, cj + 2 <= j_hi ? cj + 2 : -1);
        zero_row(cj + 1);
        cp_async_wait1();  // rows up to cj + 1 have arrived
        __syncthreads();
        const bool below = cj + 1 < a.ny;
        if (below) code_row<P>(a, b, smem, L, cj + 1);
        // each target's insertion offsets from its first 6 sources (rows
        // cj - 1 and cj, coded already), in the reference's order
        // k = 3 (a + 1) + b + 1; sources 6-8 lie in row cj + 1
        if (threadIdx.x < txe) {
            const int lt = threadIdx.x;
            int running = 0;
            for (int k = 0; k < 6; ++k) {
                off[9 * lt + k] = running;
                const int sj = cj + k / 3 - 1;
                if (sj >= 0) running += count(sj, lt + k % 3, 8 - k);
            }
            off[9 * lt + 6] = running;
        }
        __syncthreads();

        // each target's count and arrivals: sources 6-8 from row cj + 1
        // (none where no slot of it moves up)
        const bool up = below && reinterpret_cast<const unsigned*>(
            smem + ((cj + 1) & (RING - 1)) * L.row + L.movers)[0] != 0u;
        if (threadIdx.x < txe) {
            const int lt = threadIdx.x;
            int total = off[9 * lt + 6];
            if (up)
                for (int k = 6; k < 9; ++k)
                    total += count(cj + 1, lt + k - 6, 8 - k);
            counts[lt] = min(total, K);
            if constexpr (ARR)
                a.arrivals[b.dst.cell(cj, i0 + lt)] = total;
            else
                drops += max(total - K, 0);
        }

        // scatter every slot bound for row cj to its place; a neighbour
        // row none of whose slots moves to row cj is skipped whole
        for (int da = -1; da <= 1; ++da) {
            const int sj = cj + da;
            if (sj < 0 || sj >= a.ny) continue;
            const int rb = (sj & (RING - 1)) * L.row;
            if (da > 0 ? !up
                       : da < 0 && reinterpret_cast<const unsigned*>(
                                       smem + rb + L.movers)[1] == 0u)
                continue;
            const float* f = reinterpret_cast<const float*>(smem + rb);
            const int* fmat = reinterpret_cast<const int*>(f + 3 * L.S);
            const unsigned* mask =
                reinterpret_cast<const unsigned*>(smem + rb + L.mask);
            const CodeBase cb(a, b, L, rb, sj, lh, rh);
            const int row_code = (1 - da) * 3;  // the first code bound for cj
            SlotWalk w(K);
            for (int e = threadIdx.x; e < (txe + 2) * K; e += NT, w.next(K)) {
                const int c = smem[cb.at(w.lc, txe) + e] - row_code;
                if (c < 0 || c > 2) continue;  // NONE or another row
                const int lt = w.lc + c - 2;
                if (lt < 0 || lt >= txe) continue;
                const int code = row_code + c, k = 8 - code;
                int dest = off[9 * lt + min(k, 6)]
                           + mask_count(mask, L, w.lc, code, w.s);
                // the earlier sources of row cj + 1
                for (int kk = 6; kk < k; ++kk)
                    dest += count(sj, lt + kk - 6, 8 - kk);
                if (dest >= K) continue;
                const int d = lt * K + dest;
                out[d] = f[e];
                out[TK + d] = f[L.S + e];
                out[2 * TK + d] = f[2 * L.S + e];
                omat[d] = fmat[e];
            }
        }
        __syncthreads();

        // the output row: txe buckets, contiguous in every stream
        const long long g = b.dst.cell(cj, i0) * K;
        SlotWalk w(K);
        for (int e = threadIdx.x; e < txe * K; e += NT, w.next(K)) {
            const bool v = w.s < counts[w.lc];
            a.ox[g + e] = v ? out[e] : 0.0f;
            a.oy[g + e] = v ? out[TK + e] : 0.0f;
            a.oT[g + e] = v ? out[2 * TK + e] : 0.0f;
            a.omat[g + e] = v ? omat[e] : 0;
            a.ovalid[g + e] = v ? 1 : 0;
        }
        // the next scatter writes the output row after two barriers
    }

    asm volatile("cp.async.wait_all;\n" ::);  // (empty groups only)
    if constexpr (!ARR) {
        int* red = reinterpret_cast<int*>(smem + L.red);
        for (int o = 16; o > 0; o >>= 1)
            drops += __shfl_down_sync(0xffffffffu, drops, o);
        if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = drops;
        __syncthreads();
        if (threadIdx.x == 0) {
            int sum = 0;
            for (int w = 0; w < NWARPS; ++w) sum += red[w];
            if (sum > 0)
                atomicAdd(a.dropped, static_cast<unsigned long long>(sum));
        }
    }
}

// Occupancy of kernel `fn` with smem dynamic shared bytes (the attribute
// set first): out = {registers per thread, static shared bytes, local
// (spill) bytes per thread, resident blocks per SM, threads per block,
// dynamic shared bytes}.
inline int kernel_info(const void* fn, int smem, int* out) {
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

}  // namespace rebucket_rows
