// Fused marker -> grid transfer: every per-step stream of the interp and
// energy phases in one pass over the (ny, nx, K) bucketed markers.
//
// Replaces: pylamp_tpu/markers/pallas/m2g_kernel.py:m2g_fused_pallas.
//
// Bound on the H100: memory.  At 1024^2 x K18 (18.9 M slots) it reads the
// five marker streams once (x, y, T f32, mat i32, valid u8: 321 MB) and
// writes 9 node planes of ~1 M floats (38 MB): ~0.36 GB, ~0.11 ms at
// 3.35 TB/s.  Each marker's properties (one expf + one logf for the FK
// law) are evaluated by the up to 9 node threads it touches.
//
// Design: a gather, one thread per node (J, I) of the (ny+1, nx+1) corner
// index space; the same thread also owns the center (J, I), vy (J, I) and
// vx (J, I) nodes where those exist.  Its walk over the slots of the 3x3
// cells that can reach its nodes, in a fixed order, is m2g_node.cuh's
// (shared with the per-shard m2g_block.cu).  Properties come from (mat, T)
// in the kernel, with the material table passed by value.
// No atomics: each node has exactly one writer and a fixed summation
// order, so the result is deterministic (the reference is bitwise
// deterministic by design).  expf/logf (not the __expf intrinsics) keep
// full f32 accuracy.  The output is the same raw weighted-sum dict as the
// TPU kernel, so the caller's division step is shared.
//
// Periodic side walls (flag PERIODIC, the P instantiation; P = false is
// the wall form, unchanged): the threads of node columns 0..nx-1 gather
// with the x neighbourhood wrapped (m2g_node.cuh), and the column-0 thread
// also writes the seam column nx of the corner and vx lattices, so both
// seam columns carry the one seam sum, from one fixed gather order.
//
// The rho0 * alpha corner stream (flag WITH_RA, with the energy streams;
// the RA instantiations) is one more register accumulator of the same
// gather, written like c_H, the seam column included.
#include "common.cuh"
#include "m2g_node.cuh"

namespace {

// the (ny, nx, K) bucket layout
struct GlobalCells {
    int nx, K;
    __device__ __forceinline__ long long base(int cj, int ci) const {
        return (static_cast<long long>(cj) * nx + ci) * K;
    }
};

template <bool P, bool RA>
__global__ void m2g_kernel(const float* __restrict__ x,
                           const float* __restrict__ y,
                           const float* __restrict__ T,
                           const int* __restrict__ mat,
                           const unsigned char* __restrict__ valid,
                           M2GTable tbl, M2GOut out, int ny, int nx, int K,
                           float dx, float dy, int flags) {
    const int I = blockIdx.x * blockDim.x + threadIdx.x;
    const int J = blockIdx.y * blockDim.y + threadIdx.y;
    if (I > nx || J > ny) return;
    if (P && I == nx) return;  // the seam column: the column-0 thread's
    const NodeSums r = m2g_gather<P, RA>(GlobalCells{nx, K}, x, y, T, mat,
                                         valid, tbl, J, I, ny, nx, K, dx, dy,
                                         flags);

    const long long qc = static_cast<long long>(J) * (nx + 1) + I;
    const long long qn = static_cast<long long>(J) * nx + I;
    // P: the corner and vx sums of column 0 go to column nx as well
    const bool seam = P && I == 0;
    const long long qs = qc + nx;
    out.p[C_W][qc] = r.v[C_W];
    out.p[C_ETA][qc] = r.v[C_ETA];
    if (seam) {
        out.p[C_W][qs] = r.v[C_W];
        out.p[C_ETA][qs] = r.v[C_ETA];
    }
    if (r.has_n) {
        out.p[N_W][qn] = r.v[N_W];
        out.p[N_ETA][qn] = r.v[N_ETA];
    }
    if (r.has_vy) {  // vy lattice (ny+1, nx)
        out.p[VY_W][qn] = r.v[VY_W];
        out.p[VY_RHO][qn] = r.v[VY_RHO];
    }
    if (r.has_vx) {  // vx lattice (ny, nx+1)
        out.p[VX_W][qc] = r.v[VX_W];
        out.p[VX_RHO][qc] = r.v[VX_RHO];
        if (seam) {
            out.p[VX_W][qs] = r.v[VX_W];
            out.p[VX_RHO][qs] = r.v[VX_RHO];
        }
    }
    if (flags & WITH_ENERGY) {
        out.p[C_T][qc] = r.v[C_T];
        out.p[C_K][qc] = r.v[C_K];
        out.p[C_RHOCP][qc] = r.v[C_RHOCP];
        if (flags & WITH_H) out.p[C_H][qc] = r.v[C_H];
        if (RA) out.p[C_RA][qc] = r.v[C_RA];
        if (seam) {
            out.p[C_T][qs] = r.v[C_T];
            out.p[C_K][qs] = r.v[C_K];
            out.p[C_RHOCP][qs] = r.v[C_RHOCP];
            if (flags & WITH_H) out.p[C_H][qs] = r.v[C_H];
            if (RA) out.p[C_RA][qs] = r.v[C_RA];
        }
    }
}

}  // namespace

PYLAMP_EXPORT int launch_m2g(const float* x, const float* y, const float* T,
                             const int* mat, const unsigned char* valid,
                             const void* table, const void* outs, int ny,
                             int nx, int K, float dx, float dy, int flags,
                             cudaStream_t stream) {
    const M2GTable tbl = *static_cast<const M2GTable*>(table);
    M2GOut out;
    for (int n = 0; n < N_OUT; ++n)
        out.p[n] = static_cast<float* const*>(outs)[n];
    dim3 block(32, 4);
    const dim3 grid = grid2d(ny + 1, nx + 1, block);
    // RA only with the energy streams, as the wrapper sets it
    const bool ra = (flags & WITH_RA) && (flags & WITH_ENERGY);
    auto kernel = (flags & PERIODIC) ? (ra ? m2g_kernel<true, true>
                                           : m2g_kernel<true, false>)
                                     : (ra ? m2g_kernel<false, true>
                                           : m2g_kernel<false, false>);
    kernel<<<grid, block, 0, stream>>>(x, y, T, mat, valid, tbl, out, ny, nx,
                                       K, dx, dy, flags);
    return launch_status();
}
