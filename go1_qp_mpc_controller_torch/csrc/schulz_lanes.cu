// K4: scaled Newton-Schulz inverse of small unbalanced SPD matrices (the
// EKF's 28 x 28 innovation matrices), one block of 4 warps per matrix,
// for sm_90a.
//
// Replaces the TPU kernel go1_qp_mpc_controller_tpu/ops/pallas_admm.py
// schulz_inverse_lanes (_schulz_lanes_kernel = schulz_lanes_body). The
// plain PyTorch version of the same function is
// ops/kkt_schulz.py::schulz_balanced_plain at the same coefficients.
//
// What it computes, per matrix: the Jacobi balance M_b = S M S
// (S = diag(M)^-1/2), the cold scaled schedule from c0 = 1 / (1.05
// ||M_b||_inf) (row sums: the input is not symmetrized) with its first
// step folded (no product), then the unbalance S X S. All FP32 FMA, like
// the TPU kernel's VPU arithmetic (no TF32, no bf16).
//
// What bounds it on an H100: operations. The 12-step schedule of
// admm._scaled_schulz_coeffs(1e-5) is 11 steps of two 28 x 28 x 28
// products after the folded first one: 0.97 MFLOP a matrix against 6.3 KB
// of traffic (the matrix in, the inverse out). At batch 4096 that is
// 4.0 GFLOP (0.059 ms at 67 TFLOP/s) against 25.7 MB (0.008 ms at
// 3.35 TB/s).
//
// What the design does about it: K2's column-owner layout
// (csrc/observe_ekf.cu), with the rows of every product split over 4
// warps. Lane c owns column c of each product's result and holds the
// right operand's column c in registers; warp w computes rows
// 7w .. 7w + 6 of every column, reading each row of the left operand as
// float4s that all lanes of the warp share (one broadcast shared load
// feeds 4 FMAs a lane; 7 independent accumulators). A step
// X' = X ((2a) I - a^2 M_b X) takes two products, T = M_b X[:, c] and
// X'[:, c] = X T'[:, c]. Each product's result crosses warps: every warp
// stores its rows (of T', then of the new X, double-buffered) and after
// the block's barrier every lane reads its column back, one row of
// consecutive words a load: two barriers a step. Each entry is summed
// over k in order, one FMA chain, as K3's FP32 body sums it
// (schulz_body.cuh), with the same balance and norm. Four warps a matrix
// read fastest at batch 1, the only batch a path launches (1 and 2 warps
// were measured too, see PERF.md). The matrix and the inverse cross
// device memory once each, coalesced.

#include <cuda_runtime.h>
#include <math.h>

#include "schulz_body.cuh"

namespace {

constexpr int N = 28;
constexpr int W = 4;             // warps a matrix
constexpr int NT = 32 * W;
constexpr int RL = N / W;        // rows a warp computes
static_assert(RL * W == N, "the warps tile the rows");

__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || a > b) ? a : b;
}

// out[i] = sum_k A[i][k] v[k] for the RL rows of A (row stride N) and a
// column v in registers; every lane of the warp reads the same row of A,
// as broadcast float4s; k in order.
__device__ __forceinline__ void rows_times(const float* A,
                                           const float (&v)[N],
                                           float (&out)[RL]) {
#pragma unroll
    for (int i = 0; i < RL; ++i) out[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < N; k += 4) {
#pragma unroll
        for (int i = 0; i < RL; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(A + i * N + k);
            out[i] = fmaf(a.x, v[k], out[i]);
            out[i] = fmaf(a.y, v[k + 1], out[i]);
            out[i] = fmaf(a.z, v[k + 2], out[i]);
            out[i] = fmaf(a.w, v[k + 3], out[i]);
        }
    }
}

// Lane c's column of the N x N row-major matrix `src` into registers (a
// warp reads one row a load: consecutive words).
__device__ __forceinline__ void read_column(const float* src, int c,
                                            float (&v)[N]) {
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] = src[r * N + c];
}

__global__ void __launch_bounds__(NT)
schulz_lanes_kernel(const float* __restrict__ m,     // (B, 28, 28)
                    float* __restrict__ out,         // (B, 28, 28)
                    schulz::Schedule sched, int n_coeffs) {
    __shared__ __align__(16) float mb[N * N];          // M, then M_b
    __shared__ __align__(16) float xs[2][N * N];       // X, double-buffered
    __shared__ __align__(16) float ts[N * N];          // T'
    __shared__ float sv[N];                            // s = diag(M)^-1/2

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const bool act = lane < N;       // lanes 28..31 store nothing
    const int c = act ? lane : N - 1;                  // the lane's column
    const int r0 = (tid >> 5) * RL;                    // the warp's rows

    // the Jacobi balance M_b = M s_i s_j, the diagonal read first
    const size_t off = (size_t)blockIdx.x * N * N;
    if (tid < N) sv[tid] = rsqrtf(m[off + tid * (N + 1)]);
    __syncthreads();
    for (int idx = tid; idx < N * N; idx += NT)
        mb[idx] = m[off + idx] * (sv[idx / N] * sv[idx % N]);
    __syncthreads();

    // ||M_b||_inf by row sums (j in order), each warp for itself
    float row = -INFINITY;
    if (act) {
        row = 0.0f;
#pragma unroll
        for (int j = 0; j < N; j += 4) {
            const float4 q =
                *reinterpret_cast<const float4*>(mb + lane * N + j);
            row += fabsf(q.x);
            row += fabsf(q.y);
            row += fabsf(q.z);
            row += fabsf(q.w);
        }
    }
    for (int o = 16; o > 0; o >>= 1)
        row = nan_max(row, __shfl_xor_sync(0xffffffffu, row, o));
    const float ac = sched.a[0] * (1.0f / (1.05f * row));

    // the first step from c0 I, folded: X = ac (2 I - ac M_b); the lane's
    // column in registers, the warp's rows in xs[0]
    float xc[N];
#pragma unroll
    for (int r = 0; r < N; ++r)
        xc[r] = ac * ((r == c ? 2.0f : 0.0f) - ac * mb[r * N + c]);
    if (act) {
#pragma unroll
        for (int i = 0; i < RL; ++i) {
            const int r = r0 + i;
            xs[0][r * N + c] =
                ac * ((r == c ? 2.0f : 0.0f) - ac * mb[r * N + c]);
        }
    }
    __syncthreads();

    int cur = 0;
    for (int k = 1; k < n_coeffs; ++k) {
        const float two_a = 2.0f * sched.a[k];
        const float a2 = sched.a[k] * sched.a[k];
        float part[RL], tc[N];
        rows_times(mb + r0 * N, xc, part);               // M_b X[:, c]
        if (act) {
#pragma unroll
            for (int i = 0; i < RL; ++i)
                ts[(r0 + i) * N + c] =
                    (r0 + i == c ? two_a : 0.0f) - a2 * part[i];
        }
        __syncthreads();
        read_column(ts, c, tc);
        rows_times(xs[cur] + r0 * N, tc, part);          // X T'[:, c]
        if (act) {
#pragma unroll
            for (int i = 0; i < RL; ++i)
                xs[cur ^ 1][(r0 + i) * N + c] = part[i];
        }
        cur ^= 1;
        __syncthreads();
        read_column(xs[cur], c, xc);
    }

    // unbalance: M^-1 = S X S
    for (int idx = tid; idx < N * N; idx += NT)
        out[off + idx] = xs[cur][idx] * (sv[idx / N] * sv[idx % N]);
}

}  // namespace

extern "C" int schulz_lanes_launch(const float* m, float* out,
                                   const float* coeffs, int n_coeffs,
                                   int batch, cudaStream_t stream) {
    if (n_coeffs < 1 || n_coeffs > schulz::MAX_COEFFS)
        return (int)cudaErrorInvalidValue;
    const schulz::Schedule sched = schulz::make_schedule(coeffs, n_coeffs);
    schulz_lanes_kernel<<<batch, NT, 0, stream>>>(m, out, sched, n_coeffs);
    return (int)cudaGetLastError();
}
