// The repack of one TARGET cell, shared by the single-device rebucket
// (rebucket.cu) and the per-shard rebucket on extended marker blocks
// (rebucket_block.cu).  It walks the 3x3 source cells in exactly the
// reference's insertion order -- a in (-1, 0, 1), then b in (-1, 0, 1),
// then slot s ascending -- takes every valid marker whose owning cell
// clip((int)(x / dx)) is this cell, inserts it at `count` while count < K,
// fills the rest of the bucket with empty slots, and returns every arrival
// for the overflow drop count.  The owning cell uses IEEE f32 division by
// the f32 cell size, as the reference traces it (no --use_fast_math).
//
// P (periodic side walls, a template switch; P = false is the form above,
// unchanged): the source columns wrap, (ci + b) mod nx, with no edge
// mask.  For nx >= 3 the reference's wrapped offset test
// (ti - si + 1) mod nx - 1 == -b holds exactly when ti == ci, the test
// below, so the order and the result stay those of the plain version.
#pragma once

#include <cuda_runtime.h>

// Cells::base(sj, si): first slot of global source cell (sj, si), or -1
// where the layout has no such cell.  The target bucket starts at out_base.
template <bool P = false, class Cells>
__device__ __forceinline__ int rebucket_cell(
    const Cells& cells, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ T,
    const int* __restrict__ mat, const unsigned char* __restrict__ valid,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ oT,
    int* __restrict__ omat, unsigned char* __restrict__ ovalid,
    long long out_base, int cj, int ci, int ny, int nx, int K, float dx,
    float dy) {
    int count = 0;
    int arrivals = 0;
    for (int a = -1; a <= 1; ++a) {
        const int sj = cj + a;
        if (sj < 0 || sj >= ny) continue;
        for (int b = -1; b <= 1; ++b) {
            int si = ci + b;
            if constexpr (P) {
                si = si < 0 ? si + nx : (si >= nx ? si - nx : si);
            } else {
                if (si < 0 || si >= nx) continue;
            }
            const long long in_base = cells.base(sj, si);
            if (in_base < 0) continue;
            for (int s = 0; s < K; ++s) {
                const long long q = in_base + s;
                if (!valid[q]) continue;
                const float px = x[q];
                const float py = y[q];
                const int ti = min(max(static_cast<int>(px / dx), 0), nx - 1);
                const int tj = min(max(static_cast<int>(py / dy), 0), ny - 1);
                if (ti != ci || tj != cj) continue;
                ++arrivals;
                if (count < K) {
                    const long long o = out_base + count;
                    ox[o] = px;
                    oy[o] = py;
                    oT[o] = T[q];
                    omat[o] = mat[q];
                    ovalid[o] = 1;
                    ++count;
                }
            }
        }
    }
    for (int s = count; s < K; ++s) {
        const long long o = out_base + s;
        ox[o] = 0.0f;
        oy[o] = 0.0f;
        oT[o] = 0.0f;
        omat[o] = 0;
        ovalid[o] = 0;
    }
    return arrivals;
}
