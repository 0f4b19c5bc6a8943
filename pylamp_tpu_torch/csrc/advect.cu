// Fused RK4 marker advection in the (ny, nx, K) bucket layout.
//
// Replaces: pylamp_tpu/markers/pallas/advect_kernel.py:advect_rk4_pallas.
//
// Bound on the H100: memory.  At 1024^2 x K18 (18.9 M slots) it reads
// x, y (f32) and valid (u8) — 170 MB — and writes the new x, y (151 MB):
// ~0.32 GB, ~0.1 ms at 3.35 TB/s.  The ghost-padded velocity lattices
// (2 x 4.2 MB) stay resident in L2 for the 32 bilinear reads per marker
// (4 stages x 2 lattices x 4 corners); ~200 flops per marker.
//
// Design: one thread per marker slot; all four RK stages in registers.
// Each stage samples vx_p (ny+2, nx+1) and vy_p (ny+1, nx+2) — the same
// ghost-padded lattices as the reference, built by the wrapper — with a
// clamped bilinear gather.  A corner contributes only if its node lies in
// the reference's shift window [-reach, reach+1] around the marker's
// bucket cell; `reach` is that precondition (1 for the first stage, the
// Courant-derived stage reach after), not a layout parameter.  Empty slots
// sample zero velocity.  The result is clipped to the closed domain like
// the reference.  dt is read from device memory (no host sync).
#include "common.cuh"

namespace {

struct Lattice {
    const float* f;
    int rows, cols;

    // bilinear sample at array coordinates (fx, fy), masked to the shift
    // window around bucket cell (cj, ci)
    __device__ float sample(float fx, float fy, int cj, int ci,
                            int reach) const {
        const int i0 = static_cast<int>(
            fminf(fmaxf(floorf(fx), 0.0f), static_cast<float>(cols - 2)));
        const int j0 = static_cast<int>(
            fminf(fmaxf(floorf(fy), 0.0f), static_cast<float>(rows - 2)));
        const float tx = fminf(fmaxf(fx - static_cast<float>(i0), 0.0f), 1.0f);
        const float ty = fminf(fmaxf(fy - static_cast<float>(j0), 0.0f), 1.0f);
        float out = 0.0f;
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
#pragma unroll
            for (int di = 0; di < 2; ++di) {
                const int oj = j0 + dj - cj;
                const int oi = i0 + di - ci;
                if (oj < -reach || oj > reach + 1 || oi < -reach ||
                    oi > reach + 1)
                    continue;
                const float wy = dj ? ty : 1.0f - ty;
                const float wx = di ? tx : 1.0f - tx;
                out = out + (wy * wx) * f[(j0 + dj) * cols + (i0 + di)];
            }
        }
        return out;
    }
};

__global__ void advect_kernel(const float* __restrict__ x,
                              const float* __restrict__ y,
                              const unsigned char* __restrict__ valid,
                              Lattice vxl, Lattice vyl,
                              const float* __restrict__ dt_ptr,
                              float* __restrict__ out_x,
                              float* __restrict__ out_y, int nx, int K,
                              long long n, float dx, float dy, float x_lo,
                              float x_hi, float y_lo, float y_hi, int reach) {
    const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    if (q >= n) return;
    const long long cell = q / K;
    const int cj = static_cast<int>(cell / nx);
    const int ci = static_cast<int>(cell % nx);
    const float px = x[q];
    const float py = y[q];
    const bool vl = valid[q] != 0;
    const float dt = *dt_ptr;

    auto vel = [&](float sx, float sy, int r, float& ux, float& uy) {
        if (!vl) {
            ux = 0.0f;
            uy = 0.0f;
            return;
        }
        ux = vxl.sample(sx / dx, sy / dy + 0.5f, cj, ci, r);
        uy = vyl.sample(sx / dx + 0.5f, sy / dy, cj, ci, r);
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
    out_x[q] = fminf(fmaxf(xn, x_lo), x_hi);
    out_y[q] = fminf(fmaxf(yn, y_lo), y_hi);
}

}  // namespace

PYLAMP_EXPORT int launch_advect(const float* x, const float* y,
                                const unsigned char* valid, const float* vx_p,
                                const float* vy_p, const float* dt,
                                float* out_x, float* out_y, int ny, int nx,
                                int K, float dx, float dy, float x_lo,
                                float x_hi, float y_lo, float y_hi, int reach,
                                cudaStream_t stream) {
    const long long n = static_cast<long long>(ny) * nx * K;
    Lattice vxl{vx_p, ny + 2, nx + 1};
    Lattice vyl{vy_p, ny + 1, nx + 2};
    const int threads = 256;
    const unsigned int blocks =
        static_cast<unsigned int>((n + threads - 1) / threads);
    advect_kernel<<<blocks, threads, 0, stream>>>(
        x, y, valid, vxl, vyl, dt, out_x, out_y, nx, K, n, dx, dy, x_lo,
        x_hi, y_lo, y_hi, reach);
    return launch_status();
}
