// The marker -> grid gather of one node thread of the per-shard transfer
// on extended marker blocks (m2g_block.cu), and the material table, the
// lattice intervals and the marker properties it shares with the
// single-device transfer (m2g.cu): the node (J, I) of the (ny+1, nx+1)
// corner index space
// and the center (J, I), vy (J, I) and vx (J, I) nodes where those exist.
// It walks the slots of the 3x3 cells (J-1..J+1, I-1..I+1) that can reach
// its nodes in a fixed order -- cell rows, then cell columns ascending,
// then slots ascending -- and accumulates w and w*v of every stream in
// registers.  Marker properties come from (mat, T) and the material table.
// The same order on the same markers gives the same sums, whichever
// layout the cells come from.
//
// P (periodic side walls, a template switch; P = false is the form above,
// unchanged): the thread of node column I < nx gathers from the cell
// columns (I - 1, I, I + 1) mod nx, and a marker's x weight has no clamp:
// its lattice interval starts at floor(f), counted from its own cell and
// shifted by the wrap of that cell (markers/bucket.py _lattice_local with
// periodic_x).  The caller writes the seam column nx of the nx+1-wide
// lattices from the column-0 thread.
//
// RA (a template switch; RA = false is the form above, unchanged): with the
// energy streams, one more corner accumulator, w * rho0 * alpha of the
// marker's material (adiabatic heating's coefficient), in the same slot
// order as every other corner stream.
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

// weight of node `node` from a marker at lattice coordinate f
__device__ __forceinline__ float hat(float f, int n_nodes, int node) {
    int i0;
    float t;
    interval(f, n_nodes, i0, t);
    return hat_weight(node, i0, t);
}

// the same hat on a periodic axis: no clamp; the marker's interval starts
// at floor(f) + shift (shift: the unwrapped minus the stored column of its
// cell), and node is the unwrapped node column
__device__ __forceinline__ float hat_px(float f, int shift, int node) {
    int i0;
    float t;
    interval_px(f, i0, t);
    return hat_weight(node, i0 + shift, t);
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

// The sums of one node thread, and which of its nodes exist.
struct NodeSums {
    float v[N_OUT];
    bool has_n, has_vy, has_vx;
};

// The markers' streams; Cells::base(cj, ci) is the first slot of global
// cell (cj, ci) in them, or -1 where the layout has no such cell.
template <bool P = false, bool RA = false, class Cells>
__device__ __forceinline__ NodeSums m2g_gather(
    const Cells& cells, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ T,
    const int* __restrict__ mat, const unsigned char* __restrict__ valid,
    const M2GTable& tbl, int J, int I, int ny, int nx, int K, float dx,
    float dy, int flags) {
    NodeSums out;
    const bool has_n = (J < ny) && (I < nx);
    const bool has_vy = I < nx;
    const bool has_vx = (J < ny) && (flags & WITH_VX);
    const bool energy = flags & WITH_ENERGY;
    const float hx = 0.5f * dx;  // center-kind origin offsets
    const float hy = 0.5f * dy;

    float c_w = 0.f, c_eta = 0.f, n_w = 0.f, n_eta = 0.f;
    float vy_w = 0.f, vy_rho = 0.f, vx_w = 0.f, vx_rho = 0.f;
    float c_T = 0.f, c_k = 0.f, c_rhocp = 0.f, c_H = 0.f, c_ra = 0.f;

    for (int cj = J - 1; cj <= J + 1; ++cj) {
        if (cj < 0 || cj >= ny) continue;
        for (int cu = I - 1; cu <= I + 1; ++cu) {
            int ci = cu;  // the stored cell column (P: cu mod nx)
            if constexpr (P) {
                ci = cu < 0 ? cu + nx : (cu >= nx ? cu - nx : cu);
            } else {
                if (ci < 0 || ci >= nx) continue;
            }
            const long long base = cells.base(cj, ci);
            if (base < 0) continue;
            for (int s = 0; s < K; ++s) {
                const long long q = base + s;
                if (!valid[q]) continue;
                const float px = x[q];
                const float py = y[q];
                // corner-kind axes: nodes at cell edges; center-kind: at
                // cell centers (fx = (x - dx/2) / dx)
                const float fxc = (px - 0.0f) / dx;
                const float fyc = (py - 0.0f) / dy;
                const float fxn = (px - hx) / dx;
                const float fyn = (py - hy) / dy;
                const float wyc = hat(fyc, ny + 1, J);
                const float wxc = P ? hat_px(fxc, cu - ci, I)
                                    : hat(fxc, nx + 1, I);
                const float wyn = has_n || has_vx ? hat(fyn, ny, J) : 0.0f;
                const float wxn = !has_vy ? 0.0f
                                  : P ? hat_px(fxn, cu - ci, I)
                                      : hat(fxn, nx, I);
                const float w_c = wyc * wxc;
                const float w_n = has_n ? wyn * wxn : 0.0f;
                const float w_vy = has_vy ? wyc * wxn : 0.0f;
                const float w_vx = has_vx ? wyn * wxc : 0.0f;
                if (w_c == 0.0f && w_n == 0.0f && w_vy == 0.0f &&
                    w_vx == 0.0f)
                    continue;

                // marker properties from (mat, T)
                const int m = material_of(tbl, mat[q]);
                const float Tm = T[q];
                const MarkerProps pr = marker_props(tbl, m, Tm);
                const float eta = pr.eta, rho = pr.rho;

                c_w += w_c;
                c_eta += w_c * eta;
                n_w += w_n;
                n_eta += w_n * eta;
                vy_w += w_vy;
                vy_rho += w_vy * rho;
                vx_w += w_vx;
                vx_rho += w_vx * rho;
                if (energy) {
                    c_T += w_c * Tm;
                    c_k += w_c * tbl.k[m];
                    c_rhocp += w_c * (tbl.rho0[m] * tbl.cp[m]);
                    c_H += w_c * tbl.H[m];
                    if constexpr (RA)
                        c_ra += w_c * (tbl.rho0[m] * tbl.alpha[m]);
                }
            }
        }
    }
    out.v[C_W] = c_w;
    out.v[C_ETA] = c_eta;
    out.v[N_W] = n_w;
    out.v[N_ETA] = n_eta;
    out.v[VY_W] = vy_w;
    out.v[VY_RHO] = vy_rho;
    out.v[VX_W] = vx_w;
    out.v[VX_RHO] = vx_rho;
    out.v[C_T] = c_T;
    out.v[C_K] = c_k;
    out.v[C_RHOCP] = c_rhocp;
    out.v[C_H] = c_H;
    out.v[C_RA] = c_ra;
    out.has_n = has_n;
    out.has_vy = has_vy;
    out.has_vx = has_vx;
    return out;
}
