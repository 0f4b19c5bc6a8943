// The RK4 integration of one marker slot, run by advect_tile.cuh (the
// body of the single-device advection, advect.cu, and of the per-shard
// one, advect_block.cu) on a window in shared memory.  All four stages
// stay in registers; each samples the ghost-padded vx_p (ny+2, nx+1) and
// vy_p (ny+1, nx+2) lattices with a clamped bilinear gather.  A corner
// contributes only if its node lies in the reference's shift window
// [-reach, reach+1] around the marker's bucket cell; `reach` is that
// precondition (1 for the first stage, the Courant-derived stage reach
// after), not a layout parameter.  Empty slots move with zero velocity
// (rk4_empty).  The result is clipped to the closed domain like the
// reference.
//
// P (periodic side walls, a template switch; P = false is the form above,
// unchanged): the lattices are the wrapped planes the wrapper builds
// (column c of the plane holds the period's column c mod nx), x is not
// clamped, and the new x wraps into [0, lx) with the TPU kernel's formula
// xn - lx * floor(xn * (1 / lx)), two roundings as there (the tensor path
// divides instead; see markers/bucket.py wrap_x).
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

// A ghost-padded velocity lattice of rows x cols nodes (clamping uses the
// GLOBAL extent), stored from node (r0, c0) on with row stride `stride`:
// the whole lattice (r0 = c0 = 0, stride = cols) or a shard's window.
struct Lattice {
    const float* f;
    int rows, cols;
    int r0, c0, stride;

    // bilinear sample at array coordinates (fx, fy), masked to the shift
    // window around bucket cell (cj, ci) (P: no x clamp); the window test
    // is made once per corner row and column, the sum in the corner order
    // (0, 0), (0, 1), (1, 0), (1, 1)
    template <bool P = false>
    __device__ float sample(float fx, float fy, int cj, int ci,
                            int reach) const {
        // the first node of each axis as an integer in a float (fx - fi is
        // fx - (float)i0 exactly)
        const float fi = P ? floorf(fx)
                           : fminf(fmaxf(floorf(fx), 0.0f),
                                   static_cast<float>(cols - 2));
        const float fj =
            fminf(fmaxf(floorf(fy), 0.0f), static_cast<float>(rows - 2));
        const int i0 = static_cast<int>(fi), j0 = static_cast<int>(fj);
        const float tx = fminf(fmaxf(fx - fi, 0.0f), 1.0f);
        const float ty = fminf(fmaxf(fy - fj, 0.0f), 1.0f);
        // node offset o from the bucket cell is inside [-reach, reach + 1]
        const unsigned span = 2u * static_cast<unsigned>(reach) + 1u;
        auto inside = [&](int o) {
            return static_cast<unsigned>(o + reach) <= span;
        };
        const bool row0 = inside(j0 - cj), row1 = inside(j0 + 1 - cj);
        const bool col0 = inside(i0 - ci), col1 = inside(i0 + 1 - ci);
        const float* p = f + (j0 - r0) * stride + (i0 - c0);
        float out = 0.0f;
        if (row0 && col0) out = out + ((1.0f - ty) * (1.0f - tx)) * p[0];
        if (row0 && col1) out = out + ((1.0f - ty) * tx) * p[1];
        if (row1 && col0) out = out + (ty * (1.0f - tx)) * p[stride];
        if (row1 && col1) out = out + (ty * tx) * p[stride + 1];
        return out;
    }
};

// The new position (xn, yn) clipped to [x_lo, x_hi] x [y_lo, y_hi] (P: x
// wrapped into [0, lx) with the TPU kernel's two-rounding formula).
template <bool P>
__device__ __forceinline__ void rk4_place(float xn, float yn, float x_lo,
                                          float x_hi, float y_lo, float y_hi,
                                          float& out_x, float& out_y,
                                          float lx, float inv_lx) {
    if constexpr (P)
        out_x = xn - __fmul_rn(lx, floorf(__fmul_rn(xn, inv_lx)));
    else
        out_x = fminf(fmaxf(xn, x_lo), x_hi);
    out_y = fminf(fmaxf(yn, y_lo), y_hi);
}

// RK4 of the marker at (px, py) in bucket cell (cj, ci); writes the new
// position clipped to [x_lo, x_hi] x [y_lo, y_hi] (P: x wrapped into
// [0, lx) instead, with inv_lx = 1 / lx rounded to f32).  Lattice
// coordinates s / dx, s / dy are common.cuh's div_rn from inv_dx, inv_dy
// = 1 / dx, 1 / dy rounded to f32 (the correctly rounded quotients).
template <bool P = false>
__device__ __forceinline__ void rk4_marker(
    float px, float py, int cj, int ci, float dt, const Lattice& vxl,
    const Lattice& vyl, float dx, float dy, float inv_dx, float inv_dy,
    float x_lo, float x_hi, float y_lo, float y_hi, int reach, float& out_x,
    float& out_y, float lx = 0.0f, float inv_lx = 0.0f) {
    auto vel = [&](float sx, float sy, int r, float& ux, float& uy) {
        const float fx = div_rn(sx, dx, inv_dx), fy = div_rn(sy, dy, inv_dy);
        ux = vxl.sample<P>(fx, fy + 0.5f, cj, ci, r);
        uy = vyl.sample<P>(fx + 0.5f, fy, cj, ci, r);
    };

    const float hdt = 0.5f * dt;
    float k1x, k1y, k2x, k2y, k3x, k3y, k4x, k4y;
    vel(px, py, 1, k1x, k1y);
    vel(px + hdt * k1x, py + hdt * k1y, reach, k2x, k2y);
    vel(px + hdt * k2x, py + hdt * k2y, reach, k3x, k3y);
    vel(px + dt * k3x, py + dt * k3y, reach, k4x, k4y);

    const float six = dt / 6.0f;
    const float xn = px + six * (k1x + 2.0f * k2x + 2.0f * k3x + k4x);
    const float yn = py + six * (k1y + 2.0f * k2y + 2.0f * k3y + k4y);
    rk4_place<P>(xn, yn, x_lo, x_hi, y_lo, y_hi, out_x, out_y, lx, inv_lx);
}

// An empty slot's new position: the RK4 above with zero velocity, whose
// update adds dt / 6 * 0 to the position before the clip (P: the wrap).
template <bool P = false>
__device__ __forceinline__ void rk4_empty(float px, float py, float dt,
                                          float x_lo, float x_hi, float y_lo,
                                          float y_hi, float& out_x,
                                          float& out_y, float lx = 0.0f,
                                          float inv_lx = 0.0f) {
    const float zero = dt / 6.0f * 0.0f;
    rk4_place<P>(px + zero, py + zero, x_lo, x_hi, y_lo, y_hi, out_x, out_y,
                 lx, inv_lx);
}
