// K6: the fixed-iteration ADMM loop of the warm MPC tick with the KKT
// inverse resident in shared memory, one thread block per scenario, for
// sm_90a.
//
// Replaces the TPU kernel go1_qp_mpc_controller_tpu/ops/pallas_admm.py
// admm_iterations (_kernel). The plain PyTorch version of the same
// function is ops/admm_iterations.py::admm_iterations_plain (the port's
// ADMM loop, ops/admm.py::_admm_iterations, on the friction pyramid).
//
// Per scenario, from (x0, z0, y0) (z0 = clip(C x0, lb, ub) when no z0 is
// given: the warm tick's start) and with w = rho z - y:
//   rhs = sigma x - qbar + C' w;  x_t = Minv rhs;  z_t = C x_t
//   x <- alpha x_t + (1 - alpha) x;  z_mid = alpha z_t + (1 - alpha) z
//   z <- clip(z_mid + y / rho, lb, ub);  y <- y + rho (z_mid - z)
// C is the friction pyramid: per (step, leg) pair the 5 rows
// (fx + mu fz, fx - mu fz, fy + mu fz, fy - mu fz, fz) of 3 variables.
//
// What bounds it on an H100: bytes. An iteration is one 120 x 120 matvec
// (28.8 kFLOP) plus ~2 kFLOP of pyramid and projection work per scenario;
// the inverse (57.6 KB) is read once for the whole loop. At batch 4096 and
// 20 iterations: ~2.5 GFLOP (0.04 ms at the FP32 peak) against ~0.25 GB
// (0.07 ms of HBM).
//
// What the design does about it: the inverse is loaded once into shared
// memory, TRANSPOSED (mt[k][i] = Minv[i][k]), so that in the matvec the
// threads of a warp, one output row each, read consecutive words; the
// product is the true Minv rhs (a Schulz iterate is symmetric only up to
// round-off). 256 threads: thread j < 120 owns x_j and qbar_j in
// registers, thread r < 200 owns constraint row r (z, y, lb, ub, rho) in
// registers; the matvec splits k in two halves over the two 128-thread
// groups, each summed in four interleaved accumulators. Only rhs, x_t,
// the partial sums and w go through shared memory.
// Nothing but x, z and y is written back. The clip propagates NaN like
// torch.clamp, so a diverged scenario reaches the caller's non-finite
// latch.

#include <cuda_runtime.h>

namespace {

constexpr int NV = 120;          // decision variables
constexpr int NC = 200;          // constraint rows
constexpr int NT = 256;          // threads: two groups of 128
constexpr int HALF = NV / 2;     // k range of one matvec group
static_assert(HALF % 4 == 0, "four accumulators per matvec group");
constexpr size_t SMEM_BYTES =
    (size_t)(NV * NV + NV + NV + 2 * 128 + NC) * sizeof(float);

__device__ __forceinline__ float clip(float v, float lo, float hi) {
    v = v < lo ? lo : v;          // NaN stays NaN, as in torch.clamp
    return v > hi ? hi : v;
}

// Row r of C applied to the pair's (fx, fy, fz).
__device__ __forceinline__ float pyramid_row(int k, float fx, float fy,
                                             float fz, float mu) {
    const float mfz = mu * fz;
    switch (k) {
        case 0: return fx + mfz;
        case 1: return fx - mfz;
        case 2: return fy + mfz;
        case 3: return fy - mfz;
        default: return fz;
    }
}

__global__ void __launch_bounds__(NT)
admm_iterations_kernel(const float* __restrict__ minv,   // (B, NV, NV)
                       const float* __restrict__ qbar,   // (B, NV)
                       const float* __restrict__ lb,     // (B, NC)
                       const float* __restrict__ ub,     // (B, NC)
                       const float* __restrict__ rho,    // (B, NC)
                       const float* __restrict__ mu,     // (B,)
                       const float* __restrict__ x0,     // (B, NV)
                       const float* __restrict__ z0,     // (B, NC) or null
                       const float* __restrict__ y0,     // (B, NC)
                       float* __restrict__ x_out,        // (B, NV)
                       float* __restrict__ z_out,        // (B, NC)
                       float* __restrict__ y_out,        // (B, NC)
                       int iters, float alpha, float sigma) {
    extern __shared__ float smem[];
    float* mt = smem;                 // Minv transposed
    float* rhs = mt + NV * NV;
    float* xt = rhs + NV;             // x_t (x0 at the start)
    float* part = xt + NV;            // 2 x 128 matvec partial sums
    float* w = part + 2 * 128;        // rho z - y

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const float m = mu[b];
    const float* mb = minv + (size_t)b * NV * NV;
    for (int idx = tid; idx < NV * NV; idx += NT) {
        const int i = idx / NV, k = idx % NV;
        mt[k * NV + i] = mb[idx];
    }

    // variable thread j = tid < NV, row thread r = tid < NC
    float xj = 0.0f, qj = 0.0f;
    if (tid < NV) {
        xj = x0[(size_t)b * NV + tid];
        qj = qbar[(size_t)b * NV + tid];
        xt[tid] = xj;
    }
    float zr = 0.0f, yr = 0.0f, lr = 0.0f, ur = 0.0f, pr = 1.0f;
    const int pair = tid / 5, kr = tid % 5;
    if (tid < NC) {
        lr = lb[(size_t)b * NC + tid];
        ur = ub[(size_t)b * NC + tid];
        pr = rho[(size_t)b * NC + tid];
        yr = y0[(size_t)b * NC + tid];
    }
    __syncthreads();
    if (tid < NC) {
        if (z0 != nullptr) {
            zr = z0[(size_t)b * NC + tid];
        } else {
            const float* f = xt + 3 * pair;
            zr = clip(pyramid_row(kr, f[0], f[1], f[2], m), lr, ur);
        }
        w[tid] = pr * zr - yr;
    }
    __syncthreads();

    const int col = tid & 127, grp = tid >> 7;
    for (int it = 0; it < iters; ++it) {
        // rhs = sigma x - qbar + C' w
        if (tid < NV) {
            const float* wp = w + 5 * (tid / 3);
            const int axis = tid % 3;
            float ctw;
            if (axis == 0) ctw = wp[0] + wp[1];
            else if (axis == 1) ctw = wp[2] + wp[3];
            else ctw = m * (wp[0] - wp[1] + wp[2] - wp[3]) + wp[4];
            rhs[tid] = sigma * xj - qj + ctw;
        }
        __syncthreads();
        // x_t = Minv rhs: each group sums half of k in four interleaved
        // accumulators (four independent FMA chains, and partial sums of
        // 15 terms: the loop amplifies summation round-off, so the sum
        // should be no less accurate than a library matvec's)
        if (col < NV) {
            float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
            const int k0 = grp * HALF;
#pragma unroll 3
            for (int k = k0; k < k0 + HALF; k += 4) {
                s0 = fmaf(mt[k * NV + col], rhs[k], s0);
                s1 = fmaf(mt[(k + 1) * NV + col], rhs[k + 1], s1);
                s2 = fmaf(mt[(k + 2) * NV + col], rhs[k + 2], s2);
                s3 = fmaf(mt[(k + 3) * NV + col], rhs[k + 3], s3);
            }
            part[grp * 128 + col] = (s0 + s1) + (s2 + s3);
        }
        __syncthreads();
        if (tid < NV) {
            const float xtj = part[tid] + part[128 + tid];
            xt[tid] = xtj;
            xj = alpha * xtj + (1.0f - alpha) * xj;
        }
        __syncthreads();
        // relaxation, projection and dual update per constraint row
        if (tid < NC) {
            const float* f = xt + 3 * pair;
            const float zt = pyramid_row(kr, f[0], f[1], f[2], m);
            const float zmid = alpha * zt + (1.0f - alpha) * zr;
            zr = clip(zmid + yr / pr, lr, ur);
            yr = yr + pr * (zmid - zr);
            w[tid] = pr * zr - yr;
        }
        __syncthreads();
    }
    if (tid < NV) x_out[(size_t)b * NV + tid] = xj;
    if (tid < NC) {
        z_out[(size_t)b * NC + tid] = zr;
        y_out[(size_t)b * NC + tid] = yr;
    }
}

}  // namespace

extern "C" int admm_iterations_launch(const float* minv, const float* qbar,
                                      const float* lb, const float* ub,
                                      const float* rho, const float* mu,
                                      const float* x0, const float* z0,
                                      const float* y0, float* x_out,
                                      float* z_out, float* y_out, int iters,
                                      float alpha, float sigma, int batch,
                                      cudaStream_t stream) {
    if (iters < 0) return (int)cudaErrorInvalidValue;
    static bool configured = false;
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(
            admm_iterations_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    admm_iterations_kernel<<<batch, NT, SMEM_BYTES, stream>>>(
        minv, qbar, lb, ub, rho, mu, x0, z0, y0, x_out, z_out, y_out, iters,
        alpha, sigma);
    return (int)cudaGetLastError();
}
