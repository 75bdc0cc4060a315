// K4: scaled Newton-Schulz inverse of small unbalanced SPD matrices (the
// EKF's 28 x 28 innovation matrices), one thread block per matrix, for
// sm_90a.
//
// Replaces the TPU kernel go1_qp_mpc_controller_tpu/ops/pallas_admm.py
// schulz_inverse_lanes (_schulz_lanes_kernel = schulz_lanes_body). The
// plain PyTorch version of the same function is
// ops/kkt_schulz.py::schulz_balanced_plain at the same coefficients.
//
// What it computes, per matrix: the Jacobi balance M_b = S M S
// (S = diag(M)^-1/2), the cold scaled schedule from c0 = 1 / (1.05
// ||M_b||_inf) with its first step folded (no product), a = 1 steps as
// plain Newton steps, then the unbalance S X S. All FP32 FMA, like the TPU
// kernel's VPU arithmetic (no TF32, no bf16).
//
// What bounds it on an H100: operations. The 12-step schedule of
// admm._scaled_schulz_coeffs(1e-5) is 11 steps of two 28 x 28 x 28
// products after the folded first one: 0.97 MFLOP a matrix against 6.3 KB
// of traffic (the matrix in, the inverse out). At batch 4096 that is
// 4.0 GFLOP (0.059 ms at 67 TFLOP/s) against 25.7 MB (0.008 ms at
// 3.35 TB/s).
//
// What the design does about it: the TPU kept the batch in its 128 lanes
// because a 28 x 28 product wastes its 128 x 128 matrix unit. Here a
// matrix gets one block that runs K3's Schulz body (schulz_body.cuh) at
// N = 28 on 14 x 14 threads with 2 x 2 register tiles: M_b, X and the
// product scratch live in 9.5 KB of shared memory, so nine blocks share an
// SM and hide the latency of each other's dependent products. The matrix
// and the inverse cross device memory once each.

#include <cuda_runtime.h>

#include "schulz_body.cuh"

namespace {

constexpr int N = 28;
constexpr int TD = 14;
using Tile = schulz::Tile<N, TD>;

__global__ void __launch_bounds__(Tile::NTHREADS)
schulz_lanes_kernel(const float* __restrict__ m,     // (B, 28, 28)
                    float* __restrict__ out,         // (B, 28, 28)
                    schulz::Schedule sched, int n_coeffs) {
    __shared__ __align__(16) float smem[Tile::SMEM_BYTES / sizeof(float)];
    float* tm = schulz::input_slot<N>(smem);
    const size_t off = (size_t)blockIdx.x * N * N;
    for (int idx = threadIdx.x; idx < N * N; idx += Tile::NTHREADS)
        tm[idx] = m[off + idx];
    __syncthreads();
    schulz::balanced_schulz<N, TD>(smem, nullptr, sched, n_coeffs,
                                   out + off);
}

}  // namespace

extern "C" int schulz_lanes_launch(const float* m, float* out,
                                   const float* coeffs, int n_coeffs,
                                   int batch, cudaStream_t stream) {
    if (n_coeffs < 1 || n_coeffs > schulz::MAX_COEFFS)
        return (int)cudaErrorInvalidValue;
    const schulz::Schedule sched = schulz::make_schedule(coeffs, n_coeffs);
    schulz_lanes_kernel<<<batch, Tile::NTHREADS, 0, stream>>>(m, out, sched,
                                                              n_coeffs);
    return (int)cudaGetLastError();
}
