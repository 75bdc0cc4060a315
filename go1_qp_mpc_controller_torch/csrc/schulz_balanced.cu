// K5: Newton-Schulz inverse of one already-balanced 120 x 120 matrix, with
// an optional basin-safeguarded warm start, returning the BALANCED inverse;
// one cluster of 8 thread blocks, for sm_90a.
//
// Replaces the TPU kernel go1_qp_mpc_controller_tpu/ops/pallas_admm.py
// schulz_balanced (_schulz_kernel). The plain PyTorch version of the same
// function is ops/kkt_schulz.py::schulz_balanced_core with `iters` plain
// steps (with ``middle_matmul=kkt_schulz.matmul_3xtf32``, the emulation of
// the kernel's middle products).
//
// What it computes: c0 = 1 / (1.05 ||M_b||_inf); without a warm start,
// `iters` plain Newton steps from c0 I (the first folded: no product);
// with one, the basin test on M_b X0_b (min diagonal > 1e-4, max absolute
// row sum < 3) picks X0_b (2I - M_b X0_b) or the cold step c0 (2I - c0 M_b)
// for the first step, then the rest. `iters` = 0 returns the accepted start
// or c0 I. As on the TPU, the middle steps run at reduced precision (here
// 3xTF32 on the tensor cores) and the last hi_tail = min(iters, 2) steps,
// the basin test and the accepted warm step at full FP32.
//
// What bounds it on an H100: latency. One launch handles one matrix: 38
// dependent 120 x 120 x 120 products for 20 cold steps. Its work bound
// (34 middle products at three TF32 passes at 495 TFLOP/s and 4 FP32 ones
// at 67 TFLOP/s: 0.9 us) is far below what even one SM can reach.
//
// What the design does about it: K3's cluster route (schulz_tc.cuh with
// the balance and unbalance compiled out): 8 blocks on 8 SMs each own 16
// columns of every product, send their new columns of X to the others
// through distributed shared memory and meet at a cluster barrier once a
// step, so the chain runs on 8 SMs' tensor cores instead of one SM's FP32
// cores; the exchange and barrier are what is left. Only tests call the JAX
// entry.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "schulz_tc.cuh"

namespace {

namespace cg = cooperative_groups;
constexpr int N = 120;

__global__ void __launch_bounds__(schulz_tc::NTHREADS, 1)
schulz_balanced_kernel(const float* __restrict__ mb,   // (N, N) balanced
                       const float* __restrict__ x0,   // (N, N) or null
                       float* __restrict__ out,        // (N, N) balanced
                       schulz::Schedule sched, int n_coeffs, int hi_tail) {
    extern __shared__ float4 smem4[];
    cg::cluster_group cluster = cg::this_cluster();
    if (cluster.num_blocks() != schulz_tc::CLUSTER) return;
    schulz_tc::tc_schulz<true, false>(
        reinterpret_cast<float*>(smem4), (int)cluster.block_rank(),
        schulz_tc::DenseSource{mb}, x0, N, sched, n_coeffs, hi_tail, out);
}

}  // namespace

// cluster: blocks of the one cluster, schulz_tc::CLUSTER (any other size is
// handed to the device, which refuses it or the kernel does nothing).
extern "C" int schulz_balanced_launch(const float* mb, const float* x0,
                                      float* out, int iters, int hi_tail,
                                      int cluster, cudaStream_t stream) {
    if (iters < 0 || iters > schulz::MAX_COEFFS || hi_tail < 0
        || cluster < 1)
        return (int)cudaErrorInvalidValue;
    static bool configured = false;
    if (!configured) {
        int e = schulz_tc::allow_smem(
            schulz_balanced_kernel, schulz_tc::Route<true>::SMEM_BYTES);
        if (e != 0) return e;
        configured = true;
    }
    // every step plain (a = 1): make_schedule fills unused slots with 1
    const schulz::Schedule sched = schulz::make_schedule(nullptr, 0);
    return schulz_tc::launch_cluster(schulz_balanced_kernel, 1, cluster,
                                     stream, mb, x0, out, sched, iters,
                                     hi_tail < iters ? hi_tail : iters);
}
