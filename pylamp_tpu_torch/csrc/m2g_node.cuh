// The material table, the output planes and flags, the lattice intervals
// and the marker properties of the marker -> grid transfer, shared by its
// two kernels (m2g.cu, kernel 2, and m2g_block.cu, kernel 10, which run
// the gather of m2g_rows.cuh).  The expressions are the plain version's
// (markers/kernels/m2g.py, markers/bucket.py _lattice_local): a marker's
// interval on each lattice axis and its properties from (mat, T) and the
// material table.
//
// P (periodic side walls): a marker's x interval has no clamp; it starts
// at floor(f), counted from its own cell and shifted by the wrap of that
// cell (markers/bucket.py _lattice_local with periodic_x).
//
// RA: with the energy streams, one more corner stream, w * rho0 * alpha of
// the marker's material (adiabatic heating's coefficient), in the same
// slot order as every other corner stream.
#pragma once

#include <cuda_runtime.h>

constexpr int kMaxMat = 8;
constexpr float kRGas = 8.314462618f;

// must match markers/kernels/m2g.py:_Table
struct M2GTable {
    int n;
    int eta_mode;  // 0 arithmetic, 1 geometric, 2 harmonic
    float eta_min, eta_max;
    int law[kMaxMat];  // 0 constant, 1 Frank-Kamenetskii, 2 Arrhenius
    float eta0[kMaxMat], T_ref[kMaxMat], fk_gamma[kMaxMat], E_act[kMaxMat];
    float rho0[kMaxMat], alpha[kMaxMat], k[kMaxMat], cp[kMaxMat], H[kMaxMat];
};

// output planes, in this order; unused ones are null
enum Out { C_W, C_ETA, N_W, N_ETA, VY_W, VY_RHO, VX_W, VX_RHO,
           C_T, C_K, C_RHOCP, C_H, C_RA, N_OUT };
struct M2GOut {
    float* p[N_OUT];
};

enum Flags { WITH_VX = 1, WITH_ENERGY = 2, WITH_H = 4, PERIODIC = 8,
             WITH_RA = 16 };

// The lattice interval of a marker at lattice coordinate f on an axis
// whose nodes 0..n_nodes-1 sit at origin + index * h (f already in index
// units): its first node i0, clamped to [0, n_nodes - 2], and its fraction
// t in [0, 1], as markers/bucket.py:_lattice_local
__device__ __forceinline__ void interval(float f, int n_nodes, int& i0,
                                         float& t) {
    // an integer in a float: f - fl is f - (float)i0 exactly
    const float fl =
        fminf(fmaxf(floorf(f), 0.0f), static_cast<float>(n_nodes - 2));
    i0 = static_cast<int>(fl);
    t = fminf(fmaxf(f - fl, 0.0f), 1.0f);
}

// the same on a periodic axis: no clamp, i0 = floor(f) (counted from the
// marker's stored cell; the caller adds the wrap of that cell)
__device__ __forceinline__ void interval_px(float f, int& i0, float& t) {
    const float fl = floorf(f);
    i0 = static_cast<int>(fl);
    t = fminf(fmaxf(f - fl, 0.0f), 1.0f);
}

// the clamped bilinear hat: weight of node `node` from interval (i0, t)
__device__ __forceinline__ float hat_weight(int node, int i0, float t) {
    if (node == i0) return 1.0f - t;
    if (node == i0 + 1) return t;
    return 0.0f;
}

// A marker's material (an id outside the table reads material 0) and its
// properties: eta after the clamp and the averaging transform (log eta
// for geometric, 1 / eta for harmonic), and rho(T).
__device__ __forceinline__ int material_of(const M2GTable& tbl, int m0) {
    return (m0 >= 0 && m0 < tbl.n) ? m0 : 0;
}

struct MarkerProps {
    float eta, rho;
};

__device__ __forceinline__ MarkerProps marker_props(const M2GTable& tbl,
                                                    int m, float Tm) {
    float eta = tbl.eta0[m];
    if (tbl.law[m] == 1) {
        eta = tbl.eta0[m] * expf(-tbl.fk_gamma[m] * (Tm - tbl.T_ref[m]));
    } else if (tbl.law[m] == 2) {
        const float Ts = fmaxf(Tm, 1e-30f);
        const float Trs = fmaxf(tbl.T_ref[m], 1e-30f);
        eta = tbl.eta0[m] * expf(tbl.E_act[m] / (kRGas * Ts) -
                                 tbl.E_act[m] / (kRGas * Trs));
    }
    eta = fminf(fmaxf(eta, tbl.eta_min), tbl.eta_max);
    if (tbl.eta_mode == 1) {
        eta = logf(eta);
    } else if (tbl.eta_mode == 2) {
        eta = 1.0f / eta;
    }
    const float rho =
        tbl.rho0[m] * (1.0f - tbl.alpha[m] * (Tm - tbl.T_ref[m]));
    return {eta, rho};
}
