// K1: fused KKT build + Jacobi balance + basin-safeguarded (scaled)
// Newton-Schulz inverse, one thread block per scenario, for sm_90a.
//
// Replaces the TPU kernel go1_qp_mpc_controller_tpu/ops/pallas_admm.py
// schulz_inverse_kkt_batch (_schulz_kkt_kernel = _kkt_build_tile +
// _schulz_batch_body). The plain PyTorch version of the same function is
// ops/kkt_schulz.py::kkt_schulz_plain.
//
// What bounds it on an H100: operations. A Schulz step is two 120x120x120
// products (6.9 MFLOP) on a matrix that never leaves the SM, against
// 24 KB of lazy factors and 58 KB of warm start read and 58 KB of inverse
// written per scenario for the whole schedule: at batch 4096 the warm
// tick is 28 GFLOP against 0.57 GB (0.42 ms at the FP32 FMA peak vs
// 0.17 ms of HBM), and a 9-step cold schedule is 8x the flops for fewer
// bytes.
//
// What the design does about it: the KKT is built straight into shared
// memory from the lazy factors, and the Schulz body shared with K3
// (schulz_body.cuh: M_b, X and the product scratch resident in 169 KB of
// dynamic shared memory, 400 threads on 6 x 6 register tiles, full FP32
// FMA) runs the whole schedule on it, so device memory sees only the lazy
// factors, the warm start and the inverse. The TPU's 120 -> 128 padding
// was a tile artifact and is gone: the identity-padded block changes
// neither the inf-norm scale nor the iterates.

#include <cuda_runtime.h>

#include "schulz_body.cuh"

namespace {

constexpr int N = 120;           // decision variables (H * NU)
constexpr int NU = 12;           // forces per horizon step
constexpr int NSTEP = 10;        // horizon
constexpr int TD = 20;           // thread grid TD x TD, 6 x 6 outputs each
using Tile = schulz::Tile<N, TD>;
constexpr int NTHREADS = Tile::NTHREADS;

__global__ void __launch_bounds__(NTHREADS, 1)
kkt_schulz_kernel(const float* __restrict__ tiled,   // (B, 4, 12, N)
                  const float* __restrict__ dmain,   // (B, N)
                  const float* __restrict__ off1,    // (B, N)
                  const float* __restrict__ off2,    // (B, N)
                  const float* __restrict__ cost,    // (B,)
                  const float* __restrict__ coef,    // (4, 10, N)
                  const float* __restrict__ x0,      // (B, N, N) or null
                  float* __restrict__ out,           // (B, N, N)
                  schulz::Schedule sched, int n_coeffs) {
    extern __shared__ float smem[];
    float* tm = schulz::input_slot<N>(smem);   // the unbalanced M

    const int b = blockIdx.x;
    const int tid = threadIdx.x;

    // 1. M = cost H + band, H from the lazy Gram quadrants
    //    (srb.lazy_hessian semantics: H[h*12 + x, j] =
    //    sum_k coef[k, h, j] tiled[k, x, j]).
    const float* tb = tiled + (size_t)b * 4 * NU * N;
    const float cst = cost[b];
    const float* dm = dmain + (size_t)b * N;
    const float* o1 = off1 + (size_t)b * N;
    const float* o2 = off2 + (size_t)b * N;
    for (int idx = tid; idx < N * N; idx += NTHREADS) {
        const int i = idx / N, j = idx % N;
        const int h = i / NU, x = i % NU;
        float acc = coef[(0 * NSTEP + h) * N + j] * tb[(0 * NU + x) * N + j];
        acc = acc + coef[(1 * NSTEP + h) * N + j] * tb[(1 * NU + x) * N + j];
        acc = acc + coef[(2 * NSTEP + h) * N + j] * tb[(2 * NU + x) * N + j];
        acc = acc + coef[(3 * NSTEP + h) * N + j] * tb[(3 * NU + x) * N + j];
        float band = 0.0f;
        if (i == j) band = dm[i];
        else if (j == i + 1) band = o1[i];
        else if (i == j + 1) band = o1[j];
        else if (j == i + 2) band = o2[i];
        else if (i == j + 2) band = o2[j];
        tm[idx] = cst * acc + band;
    }
    __syncthreads();

    // 2-5. balance, basin test, schedule, unbalance (schulz_body.cuh)
    schulz::balanced_schulz<N, TD>(
        smem, x0 != nullptr ? x0 + (size_t)b * N * N : nullptr, sched,
        n_coeffs,
        out + (size_t)b * N * N);
}

}  // namespace

extern "C" int kkt_schulz_launch(const float* tiled, const float* dmain,
                                 const float* off1, const float* off2,
                                 const float* cost, const float* coef,
                                 const float* x0, float* out,
                                 const float* coeffs, int n_coeffs,
                                 int batch, cudaStream_t stream) {
    if (n_coeffs < 1 || n_coeffs > schulz::MAX_COEFFS)
        return (int)cudaErrorInvalidValue;
    static bool configured = false;
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(
            kkt_schulz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)Tile::SMEM_BYTES);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    kkt_schulz_kernel<<<batch, NTHREADS, Tile::SMEM_BYTES, stream>>>(
        tiled, dmain, off1, off2, cost, coef, x0, out,
        schulz::make_schedule(coeffs, n_coeffs), n_coeffs);
    return (int)cudaGetLastError();
}
