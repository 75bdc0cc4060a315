// K3: Jacobi balance + basin-safeguarded (scaled) Newton-Schulz inverse of
// an already-built UNBALANCED SPD matrix, one thread block per scenario,
// for sm_90a.
//
// Replaces the TPU kernel go1_qp_mpc_controller_tpu/ops/pallas_admm.py
// schulz_inverse_batch (_schulz_batch_kernel = _schulz_batch_body). The
// plain PyTorch version of the same function is
// ops/kkt_schulz.py::schulz_balanced_plain.
//
// Sizes: N = 120 (the dense MPC KKT of admm.solve) and N = 12 (the balance
// QP's KKT). The TPU kernel padded both to 128 with an identity block for
// its 128 x 128 matrix unit; here the tile is sized for N itself.
//
// What bounds it on an H100: operations. A Schulz step is two N x N x N
// products on a matrix that never leaves the SM; the matrix, the warm
// start and the inverse cross device memory once each. At N = 120 and
// batch 4096 the 20-step cold schedule is 40 products of 2 x 120^3, 566
// GFLOP (8.4 ms at the FP32 FMA peak) against 0.47 GB (0.14 ms of HBM).
//
// What the design does about it: the body shared with K1
// (schulz_body.cuh) keeps M_b, X and the product scratch in dynamic
// shared memory (169 KB at N = 120, 1.7 KB at N = 12), so the whole
// schedule runs from shared memory with full FP32 FMA products on
// register tiles (400 threads with 6 x 6 tiles at N = 120, 144 threads
// with one entry each at N = 12).

#include <cuda_runtime.h>

#include "schulz_body.cuh"

namespace {

template <int N, int TD>
__global__ void __launch_bounds__(TD * TD)
schulz_batch_kernel(const float* __restrict__ m,    // (B, N, N)
                    const float* __restrict__ x0,   // (B, N, N) or null
                    float* __restrict__ out,        // (B, N, N)
                    schulz::Schedule sched, int n_coeffs) {
    extern __shared__ float smem[];
    float* tm = schulz::input_slot<N>(smem);
    const size_t off = (size_t)blockIdx.x * N * N;
    for (int idx = threadIdx.x; idx < N * N; idx += TD * TD)
        tm[idx] = m[off + idx];
    __syncthreads();
    schulz::balanced_schulz<N, TD>(smem, x0 != nullptr ? x0 + off : nullptr,
                                   sched, n_coeffs, out + off);
}

template <int N, int TD>
int launch(const float* m, const float* x0, float* out,
           const schulz::Schedule& sched, int n_coeffs, int batch,
           cudaStream_t stream) {
    using Tile = schulz::Tile<N, TD>;
    static bool configured = false;
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(
            schulz_batch_kernel<N, TD>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)Tile::SMEM_BYTES);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    schulz_batch_kernel<N, TD><<<batch, Tile::NTHREADS, Tile::SMEM_BYTES,
                                 stream>>>(m, x0, out, sched, n_coeffs);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int schulz_batch_launch(const float* m, const float* x0,
                                   float* out, const float* coeffs,
                                   int n_coeffs, int n, int batch,
                                   cudaStream_t stream) {
    if (n_coeffs < 0 || n_coeffs > schulz::MAX_COEFFS)
        return (int)cudaErrorInvalidValue;
    const schulz::Schedule sched = schulz::make_schedule(coeffs, n_coeffs);
    if (n == 120) return launch<120, 20>(m, x0, out, sched, n_coeffs, batch,
                                         stream);
    if (n == 12) return launch<12, 12>(m, x0, out, sched, n_coeffs, batch,
                                       stream);
    return (int)cudaErrorInvalidValue;
}
