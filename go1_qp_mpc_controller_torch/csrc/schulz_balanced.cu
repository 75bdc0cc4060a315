// K5: Newton-Schulz inverse of one already-balanced 120 x 120 matrix, with
// an optional basin-safeguarded warm start, returning the BALANCED inverse;
// one thread block, for sm_90a.
//
// Replaces the TPU kernel go1_qp_mpc_controller_tpu/ops/pallas_admm.py
// schulz_balanced (_schulz_kernel). The plain PyTorch version of the same
// function is ops/kkt_schulz.py::schulz_balanced_core with `iters` plain
// steps.
//
// What it computes: c0 = 1 / (1.05 ||M_b||_inf); without a warm start,
// `iters` plain Newton steps from c0 I (the first folded: no product);
// with one, the basin test on M_b X0_b (min diagonal > 1e-4, max absolute
// row sum < 3) picks X0_b (2I - M_b X0_b) or the cold step c0 (2I - c0 M_b)
// for the first step, then the rest. `iters` = 0 returns the accepted start
// or c0 I. The TPU's HIGH middle steps and HIGHEST tail both run as FP32
// FMA here.
//
// What bounds it on an H100: latency. One launch handles one matrix, so
// one block on one of the 132 SMs runs the whole dependent chain: 2
// products of 2 x 120^3 FLOP a step after the first. Its FLOP bound (20
// steps: 38 products, 131 MFLOP, 2 us at 67 TFLOP/s) is far below what one
// SM can reach.
//
// What the design does about it: nothing yet beyond sharing K3's body
// (schulz_body.cuh with the balance and unbalance compiled out): M_b, X and
// the product scratch stay in 169 KB of shared memory and 400 threads own
// 6 x 6 register tiles. Only tests call the JAX entry.

#include <cuda_runtime.h>

#include "schulz_body.cuh"

namespace {

constexpr int N = 120;
constexpr int TD = 20;
using Tile = schulz::Tile<N, TD>;

__global__ void __launch_bounds__(Tile::NTHREADS)
schulz_balanced_kernel(const float* __restrict__ mb,   // (N, N) balanced
                       const float* __restrict__ x0,   // (N, N) or null
                       float* __restrict__ out,        // (N, N) balanced
                       schulz::Schedule sched, int n_coeffs) {
    extern __shared__ float smem[];
    float* tm = schulz::input_slot<N>(smem);
    for (int idx = threadIdx.x; idx < N * N; idx += Tile::NTHREADS)
        tm[idx] = mb[idx];
    __syncthreads();
    schulz::balanced_schulz<N, TD, false>(smem, x0, sched, n_coeffs, out);
}

}  // namespace

extern "C" int schulz_balanced_launch(const float* mb, const float* x0,
                                      float* out, int iters,
                                      cudaStream_t stream) {
    if (iters < 0 || iters > schulz::MAX_COEFFS)
        return (int)cudaErrorInvalidValue;
    static bool configured = false;
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(
            schulz_balanced_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)Tile::SMEM_BYTES);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    // every step plain (a = 1): make_schedule fills unused slots with 1
    const schulz::Schedule sched = schulz::make_schedule(nullptr, 0);
    schulz_balanced_kernel<<<1, Tile::NTHREADS, Tile::SMEM_BYTES, stream>>>(
        mb, x0, out, sched, iters);
    return (int)cudaGetLastError();
}
