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
// every marker kernel shares stays), in m2g_rows.cuh: one body for this
// kernel and the per-shard kernel 10 (m2g_block.cu).
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
#include "common.cuh"
#include "m2g_rows.cuh"

namespace {

using namespace m2g_rows;

// the global (ny, nx, K) buckets: cell (r, col) at (r nx + col) K (the
// launcher keeps ny nx K below 2^31; P: col wrapped into the period)
template <bool P>
struct GlobalCells {
    int nx, K;
    __device__ __forceinline__ int first(int r, int col) const {
        return (r * nx + wrapped<P>(col, nx)) * K;
    }
};

// each lattice in its own plane shape; P: the corner and vx sums of column
// 0 go to column nx as well
struct PlaneOut {
    template <bool P, bool RA>
    __device__ __forceinline__ void put(const M2GArgs& a, int J, int I,
                                        const Sums& acc, bool has_n,
                                        bool has_vy, bool has_vx) const {
        const M2GOut& out = a.out;
        const bool energy = a.flags & WITH_ENERGY;
        const long long qc = static_cast<long long>(J) * (a.nx + 1) + I;
        const long long qn = static_cast<long long>(J) * a.nx + I;
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
};

template <bool P, bool RA>
__global__ void __launch_bounds__(MAX_THREADS, 4)
m2g_kernel(const M2GArgs a, const M2GTable tbl_in) {
    const int nxn = P ? a.nx : a.nx + 1;  // node columns the threads own
    const int i0 = blockIdx.x * a.tx, j_lo = blockIdx.y * a.rows;
    // P: every column, the halo cells -1 and nx read as nx - 1 and 0
    const Block b{i0, min(a.tx, nxn - i0), j_lo, min(j_lo + a.rows, a.ny + 1),
                  0, a.ny - 1, P ? -1 : 0, P ? a.nx : a.nx - 1};
    gather_rows<P, RA>(a, tbl_in, GlobalCells<P>{a.nx, a.K}, PlaneOut{},
                       b);
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
// with WITH_ENERGY) at strips of tx columns and units of kc slots: out as
// m2g_rows.cuh kernel_info's.
PYLAMP_EXPORT int m2g_kernel_info(int tx, int kc, int split, int flags,
                                  int* out) {
    return kernel_info(reinterpret_cast<const void*>(pick(flags)), tx, kc,
                       split, out);
}
