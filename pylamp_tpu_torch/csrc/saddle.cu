// Full Stokes saddle-point apply (rx, ry, rc) for the FGMRES outer
// iterations.
//
// Replaces: pylamp_tpu/ops/pallas/stokes_kernel.py:saddle_apply_pallas
// (with prep_eta_pallas).
//
// Bound on the H100: memory.  Per call at 1024^2 it reads vx, vy, p,
// eta_s, eta_n (5.25 M floats, 21 MB) and writes rx, ry, rc (3.15 M
// floats, 12.6 MB): ~34 MB, ~10 us at 3.35 TB/s, against ~25 flops per
// output point.
//
// Design: a tiled stencil in shared memory.
//   - A block of 32 x 8 threads owns a tile of TY x TX = 16 x 32 points of
//     the (ny+1, nx+1) point space (csrc/stencil.cuh's index space), two
//     rows a thread.  It stages vx, vy, eta_s, eta_n and p for the tile
//     and a one-point ring into five planes of row stride SX = TX + 2
//     (coalesced row loads; the planes with nx + 1 columns have a row
//     pitch that is no multiple of 16 bytes, so plain 4-byte loads).  The
//     wall ghosts are resolved at the load (ghost = s * first interior row
//     or column, the value stencil.cuh forms inline); under periodic side
//     walls vy's ghost columns are the wrapped columns.
//   - The shear stress sxy is computed once per corner of the tile into a
//     shared plane (stencil.cuh computes each corner up to four times),
//     then rx, ry and rc are formed from the planes.
//   - The arithmetic is sweep_stencil.cuh's: SweepConsts' hoisted 1/dx,
//     1/dy, 2/dx^2 and 2/dy^2 multiply where stencil.cuh divides, so no
//     IEEE division is left.  That reassociation moves each result by a
//     few f32 units in the last place against the plain version (the bar
//     is 1e-5 of max |ref|, as for kernel 5).
//   - A tile whose staged frame holds no ghost and no Dirichlet or seam
//     point takes the branch-free form; only edge tiles test for walls.
//   - kbnd / kcont come from a 2-element device array, so a solve never
//     syncs the host for them.  The per-solve constants arrive as one
//     struct (ops/kernels/saddle.py builds it once per solve).
// Periodic side walls (template switch P, launched when `periodic` is
// set): the seam columns 0 and nx are one node whose row is the wrapped
// equation, half of it in each column (ops/stokes.py's convention: sxx of
// cells 0 and nx - 1 with vx columns 0, 1, nx - 1 and nx, sxy of corner
// column 0, half the wrapped pressure gradient).  The thread of column 0
// computes that half row once and writes it to both columns, so they are
// bit-identical; the thread of column nx writes nothing to rx.  The seam
// adds O(ny) work to O(ny nx).
#include "common.cuh"
#include "sweep_stencil.cuh"

// The arguments of a solve, built once per solve by the wrapper (a ctypes
// mirror in ops/kernels/saddle.py).
struct SaddleArgs {
    const float* eta_s;  // (ny+1, nx+1)
    const float* eta_n;  // (ny, nx)
    const float* kk;     // (kbnd, kcont) on the device
    int ny, nx;
    float dx, dy;
    float s_top, s_bottom, s_left, s_right;
    int periodic;
};

namespace {

constexpr int TX = 32;  // tile width (points), one per thread of a row
constexpr int TY = 16;  // tile height (points)
constexpr int BY = 8;   // thread rows: TY / BY points a thread
constexpr int SX = TX + 2;  // plane row stride: the tile and its ring
constexpr int SY = TY + 2;
constexpr int NP = SX * SY;
constexpr int NT = TX * BY;

struct Planes {
    float vx[NP], vy[NP], es[NP], en[NP], p[NP], sxy[NP];
};

struct Fields {
    const float* vx;
    const float* vy;
    const float* es;
    const float* en;
    const float* p;
    const float* kk;
    float* rx;
    float* ry;
    float* rc;
};

// Stage the frame of the tile at (j0, i0): local (lj, li) is point
// (j0 - 1 + lj, i0 - 1 + li).  EDGE: the frame may leave the domain;
// outside it vx and vy take their wall ghosts (or vy its wrapped columns
// under P) and everything else 0, which no output reads.
template <bool EDGE, bool P>
__device__ __forceinline__ void stage(Planes& s, const Fields& f,
                                      const SweepConsts& c, int j0, int i0) {
    const int ny = c.ny, nx = c.nx, W1 = nx + 1;
    for (int e = threadIdx.y * TX + threadIdx.x; e < NP; e += NT) {
        const int lj = e / SX, li = e - lj * SX;
        const int j = j0 - 1 + lj, i = i0 - 1 + li;
        if (!EDGE) {
            s.vx[e] = f.vx[j * W1 + i];
            s.vy[e] = f.vy[j * nx + i];
            s.es[e] = f.es[j * W1 + i];
            s.en[e] = f.en[j * nx + i];
            s.p[e] = f.p[j * nx + i];
            continue;
        }
        const bool in_i = i >= 0 && i <= nx;
        // vx(j, i), j in 0..ny-1, i in 0..nx; top / bottom ghost rows
        float v = 0.0f;
        if (in_i) {
            if (j == -1) v = c.s_top * f.vx[i];
            else if (j == ny) v = c.s_bottom * f.vx[(ny - 1) * W1 + i];
            else if (j >= 0 && j < ny) v = f.vx[j * W1 + i];
        }
        s.vx[e] = v;
        // vy(j, i), j in 0..ny, i in 0..nx-1; side ghosts or wrapped columns
        v = 0.0f;
        if (j >= 0 && j <= ny) {
            const float* row = f.vy + j * nx;
            if (i >= 0 && i < nx) v = row[i];
            else if (i == -1) v = P ? row[nx - 1] : c.s_left * row[0];
            else if (i == nx) v = P ? row[0] : c.s_right * row[nx - 1];
        }
        s.vy[e] = v;
        s.es[e] = (j >= 0 && j <= ny && in_i) ? f.es[j * W1 + i] : 0.0f;
        const bool cell = j >= 0 && j < ny && i >= 0 && i < nx;
        s.en[e] = cell ? f.en[j * nx + i] : 0.0f;
        s.p[e] = cell ? f.p[j * nx + i] : 0.0f;
    }
}

template <bool EDGE, bool P>
__device__ __forceinline__ void tile(Planes& s, const Fields& f,
                                     const SweepConsts& c, int j0, int i0) {
    stage<EDGE, P>(s, f, c, j0, i0);
    __syncthreads();
    // sxy once per corner (J, I) of the tile, J in j0..j0+TY, I in
    // i0..i0+TX (sweep_stencil.cuh sxy_at with the ghosts staged)
    for (int e = threadIdx.y * TX + threadIdx.x; e < (TY + 1) * (TX + 1);
         e += NT) {
        const int cj = e / (TX + 1), ci = e - cj * (TX + 1);
        const int q = (cj + 1) * SX + ci + 1;
        s.sxy[q] = s.es[q] * ((s.vx[q] - s.vx[q - SX]) * c.idy
                              + (s.vy[q] - s.vy[q - 1]) * c.idx);
    }
    __syncthreads();

    const int ny = c.ny, nx = c.nx, W1 = nx + 1;
    const float kbnd = __ldg(f.kk), kcont = __ldg(f.kk + 1);
    const int i = i0 + threadIdx.x;
#pragma unroll
    for (int r = 0; r < TY / BY; ++r) {
        const int lj = threadIdx.y + r * BY;
        const int j = j0 + lj;
        const int q = (lj + 1) * SX + threadIdx.x + 1;
        if (EDGE && (j > ny || i > nx)) continue;
        // x-momentum row at vx node (j, i), j < ny; under P the thread of
        // column 0 writes both seam columns and that of column nx none
        if (!EDGE || (j < ny && !(P && i == nx))) {
            float rxv;
            if (EDGE && P && i == 0) {
                const float n_r = s.en[q] * (s.vx[q + 1] - s.vx[q]);
                const float n_l =
                    f.en[j * nx + nx - 1]
                    * (f.vx[j * W1 + nx] - f.vx[j * W1 + nx - 1]);
                rxv = 0.5f * (-c.cxx * (n_r - n_l)
                              - c.idy * (s.sxy[q + SX] - s.sxy[q])
                              + (s.p[q] - f.p[j * nx + nx - 1]) * c.idx);
                f.rx[j * W1 + nx] = rxv;
            } else if (EDGE && (i == 0 || i == nx)) {
                rxv = kbnd * s.vx[q];
            } else {
                const float v = s.vx[q];
                const float n_r = s.en[q] * (s.vx[q + 1] - v);
                const float n_l = s.en[q - 1] * (v - s.vx[q - 1]);
                rxv = -c.cxx * (n_r - n_l)
                      - c.idy * (s.sxy[q + SX] - s.sxy[q])
                      + (s.p[q] - s.p[q - 1]) * c.idx;
            }
            f.rx[j * W1 + i] = rxv;
        }
        // y-momentum row at vy node (j, i), i < nx
        if (!EDGE || i < nx) {
            float ryv;
            if (EDGE && (j == 0 || j == ny)) {
                ryv = kbnd * s.vy[q];
            } else {
                const float v = s.vy[q];
                const float n_d = s.en[q] * (s.vy[q + SX] - v);
                const float n_u = s.en[q - SX] * (v - s.vy[q - SX]);
                ryv = -c.cyy * (n_d - n_u)
                      - c.idx * (s.sxy[q + 1] - s.sxy[q])
                      + (s.p[q] - s.p[q - SX]) * c.idy;
            }
            f.ry[j * nx + i] = ryv;
        }
        // continuity at cell (j, i)
        if (!EDGE || (j < ny && i < nx))
            f.rc[j * nx + i] = kcont * ((s.vx[q + 1] - s.vx[q]) * c.idx
                                        + (s.vy[q + SX] - s.vy[q]) * c.idy);
    }
}

template <bool P>
__global__ void __launch_bounds__(NT)
saddle_kernel(const Fields f, const SweepConsts c) {
    __shared__ Planes s;
    const int j0 = blockIdx.y * TY, i0 = blockIdx.x * TX;
    // interior: the frame (rows j0-1..j0+TY, columns i0-1..i0+TX) holds
    // no ghost, and the tile no Dirichlet row or column and no seam
    const bool interior = j0 >= 1 && j0 + TY <= c.ny - 1 && i0 >= 1
                          && i0 + TX <= c.nx - 1;
    if (interior) tile<false, P>(s, f, c, j0, i0);
    else tile<true, P>(s, f, c, j0, i0);
}

}  // namespace

PYLAMP_EXPORT int launch_saddle(const float* vx, const float* vy,
                                const float* p, float* rx, float* ry,
                                float* rc, const SaddleArgs* args,
                                cudaStream_t stream) {
    const SaddleArgs& a = *args;
    const SweepConsts c = sweep_consts(a.ny, a.nx, a.dx, a.dy, a.s_top,
                                       a.s_bottom, a.s_left, a.s_right);
    const Fields f{vx, vy, a.eta_s, a.eta_n, p, a.kk, rx, ry, rc};
    const dim3 block(TX, BY);
    const dim3 grid((a.nx + 1 + TX - 1) / TX, (a.ny + 1 + TY - 1) / TY);
    if (a.periodic)
        saddle_kernel<true><<<grid, block, 0, stream>>>(f, c);
    else
        saddle_kernel<false><<<grid, block, 0, stream>>>(f, c);
    return launch_status();
}

// Occupancy of the kernel (periodic: its P form): out = {registers per
// thread, static shared bytes, local (spill) bytes per thread, resident
// blocks per SM, threads per block, dynamic shared bytes}.
PYLAMP_EXPORT int saddle_kernel_info(int periodic, int* out) {
    const void* fn = periodic
                         ? reinterpret_cast<const void*>(saddle_kernel<true>)
                         : reinterpret_cast<const void*>(saddle_kernel<false>);
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NT, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = fa.numRegs;
    out[1] = static_cast<int>(fa.sharedSizeBytes);
    out[2] = static_cast<int>(fa.localSizeBytes);
    out[3] = blocks;
    out[4] = NT;
    out[5] = 0;
    return 0;
}

PYLAMP_EXPORT const char* pylamp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
