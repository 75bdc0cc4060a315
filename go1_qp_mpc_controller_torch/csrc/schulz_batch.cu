// K3: Jacobi balance + basin-safeguarded (scaled) Newton-Schulz inverse of
// an already-built UNBALANCED SPD matrix per scenario, for sm_90a.
//
// Replaces the TPU kernel go1_qp_mpc_controller_tpu/ops/pallas_admm.py
// schulz_inverse_batch (_schulz_batch_kernel = _schulz_batch_body). The
// plain PyTorch version of the same function is
// ops/kkt_schulz.py::schulz_balanced_plain (with ``middle_matmul=
// kkt_schulz.matmul_3xtf32``, the emulation of the n = 120 routes' middle
// products).
//
// Sizes and bodies:
//   - N = 120 (the dense MPC KKT of admm.solve): the tensor-core body of
//     schulz_tc.cuh, padded to 128, on one of two routes the caller picks:
//     one 256-thread block per scenario (the CTA route, large batch), or
//     one cluster of 8 blocks per scenario (the cluster route, small
//     batch, shared with K5);
//   - N = 12 (the balance QP's KKT), and N = 120 when hi_tail leaves the
//     schedule no 3xTF32 step (the dense warm refinement's single step):
//     the FP32 body of schulz_body.cuh (shared with K1 and K4), 144
//     threads with one entry each at N = 12, 400 threads with 6 x 6 tiles
//     on the unpadded 120 x 120 at N = 120.
//
// What bounds it on an H100: operations. A Schulz step is two N x N x N
// products on a matrix that never leaves the SM; the matrix, the warm
// start and the inverse cross device memory once each. At N = 120 and
// batch 4096 the 20-step cold schedule (first step folded, hi_tail = 2) is
// 38 products of 2 x 120^3 FLOP: 34 middle ones at three TF32 passes
// (2.9 ms at 495 TFLOP/s) and 4 tail ones in FP32 (0.8 ms at 67 TFLOP/s),
// against 0.47 GB (0.14 ms of HBM). At small batch it is latency: 38
// dependent products on one matrix.
//
// What the design does about it (schulz_tc.cuh): the whole schedule stays
// in shared memory; the middle products run 3xTF32 on the tensor cores,
// the tail and basin products FP32 FMA. The CTA route (batch above
// schulz_batch.CROSSOVER) fills the card with one 225 KB block per SM
// whose two warpgroups issue wgmma with A's fragments split in registers
// and B's k-slabs split once into a ring of hi / lo slots, each waiting
// only for the slab before the one it just issued, so the tensor cores
// never drain inside a product; what is left is each slab's own work
// around its wgmmas (B's split and staging, A's loads and splits, a
// barrier), the FP32 tail and the 32nd partial wave of 4096 / 132 blocks.
// The cluster route (up to the crossover) splits each product over 8 SMs
// (16 columns each, mma.sync), exchanging X's new columns through
// distributed shared memory, so a single matrix runs on 8 SMs instead of
// one; its exchange and cluster barrier, one a step, bound it. Above the
// crossover the clusters no longer run in one wave.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "schulz_body.cuh"
#include "schulz_tc.cuh"

namespace {

namespace cg = cooperative_groups;
using schulz_tc::NTHREADS;
using schulz_tc::Route;

// N = 12, and N = 120 without a 3xTF32 step: the FP32 body, one block per
// scenario
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

// N = 120, the CTA route: block b inverts scenario b
__global__ void __launch_bounds__(NTHREADS, 1)
schulz_tc_cta_kernel(const float* __restrict__ m,     // (B, n, n)
                     const float* __restrict__ x0,    // (B, n, n) or null
                     float* __restrict__ out,         // (B, n, n)
                     schulz::Schedule sched, int n_coeffs, int hi_tail,
                     int n) {
    extern __shared__ float4 smem4[];
    const size_t off = (size_t)blockIdx.x * n * n;
    schulz_tc::tc_schulz<false, true>(
        reinterpret_cast<float*>(smem4), 0, schulz_tc::DenseSource{m + off},
        x0 != nullptr ? x0 + off : nullptr, n, sched, n_coeffs, hi_tail,
        out + off);
}

// N = 120, the cluster route: cluster b inverts scenario b
__global__ void __launch_bounds__(NTHREADS, 1)
schulz_tc_cluster_kernel(const float* __restrict__ m,
                         const float* __restrict__ x0,
                         float* __restrict__ out,
                         schulz::Schedule sched, int n_coeffs, int hi_tail,
                         int n) {
    extern __shared__ float4 smem4[];
    cg::cluster_group cluster = cg::this_cluster();
    if (cluster.num_blocks() != schulz_tc::CLUSTER) return;
    const size_t off = (size_t)(blockIdx.x / schulz_tc::CLUSTER) * n * n;
    schulz_tc::tc_schulz<true, true>(
        reinterpret_cast<float*>(smem4), (int)cluster.block_rank(),
        schulz_tc::DenseSource{m + off},
        x0 != nullptr ? x0 + off : nullptr, n, sched, n_coeffs, hi_tail,
        out + off);
}

template <int N, int TD>
int launch_fp32(const float* m, const float* x0, float* out,
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

int launch_tc(const float* m, const float* x0, float* out,
              const schulz::Schedule& sched, int n_coeffs, int hi_tail, int n,
              int batch, int cluster, cudaStream_t stream) {
    static bool configured = false;
    if (!configured) {
        int e = schulz_tc::allow_smem(schulz_tc_cta_kernel,
                                      Route<false>::SMEM_BYTES);
        if (e == 0)
            e = schulz_tc::allow_smem(schulz_tc_cluster_kernel,
                                      Route<true>::SMEM_BYTES);
        if (e != 0) return e;
        configured = true;
    }
    if (cluster == 1) {
        schulz_tc_cta_kernel<<<batch, NTHREADS, Route<false>::SMEM_BYTES,
                               stream>>>(m, x0, out, sched, n_coeffs,
                                         hi_tail, n);
        return (int)cudaGetLastError();
    }
    return schulz_tc::launch_cluster(schulz_tc_cluster_kernel, batch,
                                     cluster, stream, m, x0, out, sched,
                                     n_coeffs, hi_tail, n);
}

}  // namespace

// cluster: blocks per scenario at n = 120, 1 (the CTA route) or
// schulz_tc::CLUSTER (the cluster route; any other size is handed to the
// device, which refuses it or the kernel does nothing), or 0: the FP32
// body of schulz_body.cuh, for schedules that hi_tail leaves no 3xTF32
// step (the warm refinement's one step); ignored at n = 12.
// hi_tail: the last steps that run FP32 at n = 120 (n = 12 runs all FP32).
extern "C" int schulz_batch_launch(const float* m, const float* x0,
                                   float* out, const float* coeffs,
                                   int n_coeffs, int hi_tail, int n,
                                   int batch, int cluster,
                                   cudaStream_t stream) {
    if (n_coeffs < 0 || n_coeffs > schulz::MAX_COEFFS || hi_tail < 0
        || cluster < 0)
        return (int)cudaErrorInvalidValue;
    const schulz::Schedule sched = schulz::make_schedule(coeffs, n_coeffs);
    if (n == 120 && cluster == 0)
        return launch_fp32<120, 20>(m, x0, out, sched, n_coeffs, batch,
                                    stream);
    if (n == 120)
        return launch_tc(m, x0, out, sched, n_coeffs,
                         hi_tail < n_coeffs ? hi_tail : n_coeffs, n, batch,
                         cluster, stream);
    if (n == 12) return launch_fp32<12, 12>(m, x0, out, sched, n_coeffs,
                                            batch, stream);
    return (int)cudaErrorInvalidValue;
}
