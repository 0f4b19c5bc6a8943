// The tile of the staged Stokes applies, one body for three kernels: the
// full saddle apply on a level's global arrays (kernel 1, saddle.cu; PR =
// true: the pressure gradient and the continuity rows), the MG momentum
// apply (kernel 7, momentum.cu; PR = false: the momentum rows of p = 0)
// and the per-shard saddle stencil on the extended blocks of every shard
// of the in-process mesh (kernel 9, saddle_block.cu; BLK, both forms).
// saddle.cu's header describes the design (a 16 x 32 tile staged with a
// one-point ring in shared memory, sxy once per corner, SweepConsts
// arithmetic, the branch-free form for interior tiles, the periodic seam
// half row computed once and written to both seam columns);
// saddle_block.cu's how kernel 9 points it at a shard's blocks.
#pragma once

#include "sweep_stencil.cuh"

// The arguments of a solve (kernel 1) or of one MG level's applies in a
// solve (kernel 7), built once by the wrapper (a ctypes mirror in
// ops/kernels/saddle.py); kernel 7 reads only kbnd of kk.
struct SaddleArgs {
    const float* eta_s;  // (ny+1, nx+1)
    const float* eta_n;  // (ny, nx)
    const float* kk;     // (kbnd, kcont) on the device
    int ny, nx;
    float dx, dy;
    float s_top, s_bottom, s_left, s_right;
    int periodic;
};

namespace saddle_tile {

constexpr int TX = 32;  // tile width (points), one per thread of a row
constexpr int TY = 16;  // tile height (points)
constexpr int BY = 8;   // thread rows: TY / BY points a thread
constexpr int SX = TX + 2;  // plane row stride: the tile and its ring
constexpr int SY = TY + 2;
constexpr int NP = SX * SY;
constexpr int NT = TX * BY;

// the staged planes (PR: with the pressure plane)
template <bool PR>
struct Planes {
    float vx[NP], vy[NP], es[NP], en[NP], p[NP], sxy[NP];
};
template <>
struct Planes<false> {
    float vx[NP], vy[NP], es[NP], en[NP], sxy[NP];
};

// A plane of an apply: point (j, i) of the tile's index space at
// a[j * ld + i].  The pointer carries the plane's origin (it may be
// shifted so that the index space's points reach the array's), ld its
// row stride.
template <class T>
struct Plane {
    T* a;
    int ld;
    __device__ __forceinline__ T& at(int j, int i) const {
        return a[j * ld + i];
    }
    __device__ __forceinline__ float ldg(int j, int i) const {
        return __ldg(a + j * ld + i);
    }
};
using In = Plane<const float>;
using Out = Plane<float>;

// The planes of an apply: p and rc only with PR; kb (kbnd) only where a
// Dirichlet row can occur (kernels 1 and 7), kc (kcont) only with PR.
// Kernels 1 and 7 index (j, i) in 0..ny x 0..nx with vx, es, rx of row
// stride nx + 1 and vy, en, p, ry, rc of stride nx; kernel 9 as
// saddle_block.cu sets out.
struct Fields {
    In vx, vy, es, en, p;
    const float* kb;
    const float* kc;
    Out rx, ry, rc;
};

// Stage the frame of the tile at (j0, i0): local (lj, li) is point
// (j0 - 1 + lj, i0 - 1 + li).  A thread stages the points e = t + k NT
// (k < NE), unrolled, through the read-only cache: the branch-free form
// has all its loads in flight at once.
//   - !EDGE: the frame lies in every plane (kernel 1 and 7's interior
//     tiles, kernel 9's full tiles).
//   - EDGE, !BLK (kernels 1 and 7): the frame may leave the domain;
//     outside it vx and vy take their wall ghosts (or vy its wrapped
//     columns under P) and everything else 0, which no output reads.
//   - EDGE, BLK (kernel 9's partial tiles): points past row ny + 1 or
//     column nx + 1, the extended block's last, are staged as 0 (no
//     output reads them).
//   - BLK: es has no point in row or column 0 of the index space (its
//     array starts at corner (1, 1)), and no output reads the frame's
//     ring row or column 0 of es, so they are not staged.
template <bool EDGE, bool P, bool PR, bool BLK>
__device__ __forceinline__ void stage(Planes<PR>& s, const Fields& f,
                                      const SweepConsts& c, int j0, int i0) {
    constexpr int NE = (NP + NT - 1) / NT;
    const int ny = c.ny, nx = c.nx;
#pragma unroll
    for (int k = 0; k < NE; ++k) {
        const int e = threadIdx.y * TX + threadIdx.x + k * NT;
        if (e >= NP) break;
        const int lj = e / SX, li = e - lj * SX;
        const int j = j0 - 1 + lj, i = i0 - 1 + li;
        if (!EDGE || BLK) {
            const bool in = !EDGE || (j <= ny + 1 && i <= nx + 1);
            s.vx[e] = in ? f.vx.ldg(j, i) : 0.0f;
            s.vy[e] = in ? f.vy.ldg(j, i) : 0.0f;
            if (!BLK || (lj > 0 && li > 0))
                s.es[e] = in ? f.es.ldg(j, i) : 0.0f;
            s.en[e] = in ? f.en.ldg(j, i) : 0.0f;
            if constexpr (PR) s.p[e] = in ? f.p.ldg(j, i) : 0.0f;
            continue;
        }
        const bool in_i = i >= 0 && i <= nx;
        // vx(j, i), j in 0..ny-1, i in 0..nx; top / bottom ghost rows
        float v = 0.0f;
        if (in_i) {
            if (j == -1) v = c.s_top * f.vx.at(0, i);
            else if (j == ny) v = c.s_bottom * f.vx.at(ny - 1, i);
            else if (j >= 0 && j < ny) v = f.vx.at(j, i);
        }
        s.vx[e] = v;
        // vy(j, i), j in 0..ny, i in 0..nx-1; side ghosts or wrapped columns
        v = 0.0f;
        if (j >= 0 && j <= ny) {
            if (i >= 0 && i < nx) v = f.vy.at(j, i);
            else if (i == -1) v = P ? f.vy.at(j, nx - 1) : c.s_left * f.vy.at(j, 0);
            else if (i == nx) v = P ? f.vy.at(j, 0) : c.s_right * f.vy.at(j, nx - 1);
        }
        s.vy[e] = v;
        s.es[e] = (j >= 0 && j <= ny && in_i) ? f.es.at(j, i) : 0.0f;
        const bool cell = j >= 0 && j < ny && i >= 0 && i < nx;
        s.en[e] = cell ? f.en.at(j, i) : 0.0f;
        if constexpr (PR) s.p[e] = cell ? f.p.at(j, i) : 0.0f;
    }
}

// The apply of the tile at (j0, i0): rx, ry (and with PR rc) at its
// points.  BLK (kernel 9): every point (j, i), j in 1..ny, i in 1..nx, has
// all its rows, none a Dirichlet row or seam, and EDGE only bounds the
// stores.
template <bool EDGE, bool P, bool PR, bool BLK = false>
__device__ __forceinline__ void tile(Planes<PR>& s, const Fields& f,
                                     const SweepConsts& c, int j0, int i0) {
    stage<EDGE, P, PR, BLK>(s, f, c, j0, i0);
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

    constexpr bool WALLS = EDGE && !BLK;
    const int ny = c.ny, nx = c.nx;
    const float kbnd = WALLS ? __ldg(f.kb) : 0.0f;
    const float kcont = PR ? __ldg(f.kc) : 0.0f;
    const int i = i0 + threadIdx.x;
#pragma unroll
    for (int r = 0; r < TY / BY; ++r) {
        const int lj = threadIdx.y + r * BY;
        const int j = j0 + lj;
        const int q = (lj + 1) * SX + threadIdx.x + 1;
        if (EDGE && (j > ny || i > nx)) continue;
        // x-momentum row at vx node (j, i), j < ny; under P the thread of
        // column 0 writes both seam columns and that of column nx none
        if (!WALLS || (j < ny && !(P && i == nx))) {
            float rxv;
            if (WALLS && P && i == 0) {
                const float n_r = s.en[q] * (s.vx[q + 1] - s.vx[q]);
                const float n_l = f.en.at(j, nx - 1)
                                  * (f.vx.at(j, nx) - f.vx.at(j, nx - 1));
                float row = -c.cxx * (n_r - n_l)
                            - c.idy * (s.sxy[q + SX] - s.sxy[q]);
                if constexpr (PR) row += (s.p[q] - f.p.at(j, nx - 1)) * c.idx;
                rxv = 0.5f * row;
                f.rx.at(j, nx) = rxv;
            } else if (WALLS && (i == 0 || i == nx)) {
                rxv = kbnd * s.vx[q];
            } else {
                const float v = s.vx[q];
                const float n_r = s.en[q] * (s.vx[q + 1] - v);
                const float n_l = s.en[q - 1] * (v - s.vx[q - 1]);
                rxv = -c.cxx * (n_r - n_l)
                      - c.idy * (s.sxy[q + SX] - s.sxy[q]);
                if constexpr (PR) rxv += (s.p[q] - s.p[q - 1]) * c.idx;
            }
            f.rx.at(j, i) = rxv;
        }
        // y-momentum row at vy node (j, i), i < nx
        if (!WALLS || i < nx) {
            float ryv;
            if (WALLS && (j == 0 || j == ny)) {
                ryv = kbnd * s.vy[q];
            } else {
                const float v = s.vy[q];
                const float n_d = s.en[q] * (s.vy[q + SX] - v);
                const float n_u = s.en[q - SX] * (v - s.vy[q - SX]);
                ryv = -c.cyy * (n_d - n_u)
                      - c.idx * (s.sxy[q + 1] - s.sxy[q]);
                if constexpr (PR) ryv += (s.p[q] - s.p[q - SX]) * c.idy;
            }
            f.ry.at(j, i) = ryv;
        }
        // continuity at cell (j, i)
        if constexpr (PR) {
            if (!WALLS || (j < ny && i < nx))
                f.rc.at(j, i) = kcont * ((s.vx[q + 1] - s.vx[q]) * c.idx
                                         + (s.vy[q + SX] - s.vy[q]) * c.idy);
        }
    }
}

// The apply of one block's tile on a level (kernels 1 and 7): the
// branch-free form where the staged frame (rows j0-1..j0+TY, columns
// i0-1..i0+TX) holds no ghost, and the tile no Dirichlet row or column
// and no seam; the edge form elsewhere.
template <bool P, bool PR>
__device__ __forceinline__ void apply_tile(Planes<PR>& s, const Fields& f,
                                           const SweepConsts& c) {
    const int j0 = blockIdx.y * TY, i0 = blockIdx.x * TX;
    const bool interior = j0 >= 1 && j0 + TY <= c.ny - 1 && i0 >= 1
                          && i0 + TX <= c.nx - 1;
    if (interior) tile<false, P, PR>(s, f, c, j0, i0);
    else tile<true, P, PR>(s, f, c, j0, i0);
}

// The apply of one block's tile on a shard's block (kernel 9), points
// (j, i) in 1..ny x 1..nx: the branch-free form where the tile is full
// (every tile of the mesh's blocks), the bounded form on the ragged last
// row and column of tiles.
template <bool PR>
__device__ __forceinline__ void apply_block_tile(Planes<PR>& s,
                                                 const Fields& f,
                                                 const SweepConsts& c) {
    const int j0 = 1 + blockIdx.y * TY, i0 = 1 + blockIdx.x * TX;
    if (j0 + TY - 1 <= c.ny && i0 + TX - 1 <= c.nx)
        tile<false, false, PR, true>(s, f, c, j0, i0);
    else
        tile<true, false, PR, true>(s, f, c, j0, i0);
}

// the launch grid of a level: tiles over its (ny+1, nx+1) points
inline dim3 tile_grid(int ny, int nx) {
    return dim3((nx + 1 + TX - 1) / TX, (ny + 1 + TY - 1) / TY);
}

// the launch grid of kernel 9: tiles over each of S shards' by x bx points
inline dim3 block_tile_grid(int S, int by, int bx) {
    return dim3((bx + TX - 1) / TX, (by + TY - 1) / TY, S);
}

// Occupancy of kernel `fn` (static shared memory only): out = {registers
// per thread, static shared bytes, local (spill) bytes per thread,
// resident blocks per SM, threads per block, dynamic shared bytes}.
inline int kernel_info(const void* fn, int* out) {
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

}  // namespace saddle_tile
