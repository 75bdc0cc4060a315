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
// What the design does about it: the balanced KKT M_b, the iterate X and
// the product scratch T live in dynamic shared memory (3 x 120^2 x 4 B =
// 169 KB of the 227 KB a block may use), so the schedule touches device
// memory only to load the lazy factors (and the warm start) and to store
// the inverse. The TPU's 120 -> 128 padding was a tile artifact and is
// gone: the identity-padded block changes neither the inf-norm scale nor
// the iterates. 400 threads own a 6 x 6 register tile each (rows
// ty + 20 r, columns tx + 20 c, so a warp reads consecutive B columns and
// at most three A rows, conflict-free); A is read as float4 along k.
// Every product is full FP32 FMA (no TF32: the scaled schedule's margin
// assumes ~1e-6 product noise). The basin test's reductions are
// block-wide and NaN-propagating, like jnp.min / jnp.max.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N = 120;           // decision variables (H * NU)
constexpr int NU = 12;           // forces per horizon step
constexpr int NSTEP = 10;        // horizon
constexpr int TD = 20;           // thread grid TD x TD
constexpr int RT = N / TD;       // 6 x 6 outputs per thread
constexpr int NTHREADS = TD * TD;
constexpr int RWARPS = (N + 31) / 32;    // full warps covering the N rows
static_assert(NTHREADS >= 32 * RWARPS, "row warps must be full");
constexpr int MAX_COEFFS = 64;
constexpr size_t SMEM_BYTES = (3 * N * N + N + 2 * RWARPS + 4) * sizeof(float);

struct Schedule {
    float a[MAX_COEFFS];
};

__device__ __forceinline__ float nan_min(float a, float b) {
    return (isnan(a) || a < b) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || a > b) ? a : b;
}

// Block-wide (min of lo, max of hi) over the values of the N row threads,
// NaN-propagating. Only the first RWARPS full warps (which cover the rows)
// shuffle; every thread calls it and gets the result.
__device__ void block_minmax(float lo, float hi, float* red, float* out_lo,
                             float* out_hi) {
    const int tid = threadIdx.x;
    if (tid < 32 * RWARPS) {
        for (int off = 16; off > 0; off >>= 1) {
            lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
            hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
        }
        if ((tid & 31) == 0) {
            red[tid >> 5] = lo;
            red[RWARPS + (tid >> 5)] = hi;
        }
    }
    __syncthreads();
    if (tid == 0) {
        float l = red[0], h = red[RWARPS];
        for (int w = 1; w < RWARPS; ++w) {
            l = nan_min(l, red[w]);
            h = nan_max(h, red[RWARPS + w]);
        }
        red[2 * RWARPS] = l;
        red[2 * RWARPS + 1] = h;
    }
    __syncthreads();
    *out_lo = red[2 * RWARPS];
    *out_hi = red[2 * RWARPS + 1];
    __syncthreads();
}

// acc = A @ B for the thread's 6 x 6 tile (rows ty + TD r, columns
// tx + TD c); A, B are N x N row-major in shared memory.
__device__ __forceinline__ void tile_product(const float* A, const float* B,
                                             int ty, int tx,
                                             float acc[RT][RT]) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < RT; ++c) acc[r][c] = 0.0f;
    for (int k = 0; k < N; k += 4) {
        float4 a[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
            a[r] = *reinterpret_cast<const float4*>(A + (ty + TD * r) * N + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            float b[RT];
#pragma unroll
            for (int c = 0; c < RT; ++c) b[c] = B[(k + kk) * N + tx + TD * c];
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                const float av = kk == 0 ? a[r].x : kk == 1 ? a[r].y
                               : kk == 2 ? a[r].z : a[r].w;
#pragma unroll
                for (int c = 0; c < RT; ++c)
                    acc[r][c] = fmaf(av, b[c], acc[r][c]);
            }
        }
    }
}

// T <- (2 a) I - a^2 (M_b X): the scaled step's right factor, written
// straight from the product's registers.
__device__ __forceinline__ void store_step_factor(float* T, int ty, int tx,
                                                  float acc[RT][RT], float aa) {
    const float two_a = 2.0f * aa;
    const float a2 = aa * aa;
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < RT; ++c) {
            const int i = ty + TD * r, j = tx + TD * c;
            T[i * N + j] = (i == j ? two_a : 0.0f) - a2 * acc[r][c];
        }
}

__device__ __forceinline__ void store_tile(float* X, int ty, int tx,
                                           float acc[RT][RT]) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < RT; ++c)
            X[(ty + TD * r) * N + tx + TD * c] = acc[r][c];
}

__global__ void __launch_bounds__(NTHREADS, 1)
kkt_schulz_kernel(const float* __restrict__ tiled,   // (B, 4, 12, N)
                  const float* __restrict__ dmain,   // (B, N)
                  const float* __restrict__ off1,    // (B, N)
                  const float* __restrict__ off2,    // (B, N)
                  const float* __restrict__ cost,    // (B,)
                  const float* __restrict__ coef,    // (4, 10, N)
                  const float* __restrict__ x0,      // (B, N, N) or null
                  float* __restrict__ out,           // (B, N, N)
                  Schedule sched, int n_coeffs) {
    extern __shared__ float smem[];
    float* mb = smem;               // balanced KKT M_b
    float* xs = mb + N * N;         // iterate X (balanced)
    float* tm = xs + N * N;         // product scratch
    float* sv = tm + N * N;         // balance scale s = diag(M)^-1/2
    float* red = sv + N;            // reduction scratch

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int ty = tid / TD, tx = tid % TD;
    const bool warm = x0 != nullptr;

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

    // 2. Jacobi balance M_b = M * s_i s_j and its inf-norm
    if (tid < N) sv[tid] = rsqrtf(tm[tid * N + tid]);
    __syncthreads();
    for (int idx = tid; idx < N * N; idx += NTHREADS) {
        const int i = idx / N, j = idx % N;
        mb[idx] = tm[idx] * (sv[i] * sv[j]);
        if (warm) xs[idx] = x0[(size_t)b * N * N + idx] / (sv[i] * sv[j]);
    }
    __syncthreads();
    float row = 0.0f;
    if (tid < N)
        for (int j = 0; j < N; ++j) row += fabsf(mb[tid * N + j]);
    float unused, norminf;
    block_minmax(INFINITY, tid < N ? row : -INFINITY, red, &unused, &norminf);
    const float c0 = 1.0f / (1.05f * norminf);

    float acc[RT][RT];
    int start = 0;
    bool ok = false;
    if (warm) {
        // 3. basin test on M_b X0_b, shared with the first Newton step
        tile_product(mb, xs, ty, tx, acc);
        store_tile(tm, ty, tx, acc);                 // tm = M_b X0_b
        __syncthreads();
        float d = INFINITY, rs = -INFINITY;
        if (tid < N) {
            d = tm[tid * N + tid];
            rs = 0.0f;
            for (int j = 0; j < N; ++j) rs += fabsf(tm[tid * N + j]);
        }
        float dmin, rmax;
        block_minmax(d, rs, red, &dmin, &rmax);      // ends in a barrier
        ok = (dmin > 1e-4f) && (rmax < 3.0f);
        if (ok) {
            store_step_factor(tm, ty, tx, acc, 1.0f);  // tm = 2I - M_b X0_b
            __syncthreads();
            tile_product(xs, tm, ty, tx, acc);       // X0_b (2I - M_b X0_b)
            __syncthreads();
            store_tile(xs, ty, tx, acc);
        } else {
            const float ac = sched.a[0] * c0;        // scaled cold step
            for (int idx = tid; idx < N * N; idx += NTHREADS) {
                const int i = idx / N, j = idx % N;
                xs[idx] = ac * ((i == j ? 2.0f : 0.0f) - ac * mb[idx]);
            }
        }
        start = 1;
    } else if (sched.a[0] != 1.0f) {
        // scaled first step folded from the scalar cold init c0 I
        const float ac = sched.a[0] * c0;
        for (int idx = tid; idx < N * N; idx += NTHREADS) {
            const int i = idx / N, j = idx % N;
            xs[idx] = ac * ((i == j ? 2.0f : 0.0f) - ac * mb[idx]);
        }
        start = 1;
    } else {
        for (int idx = tid; idx < N * N; idx += NTHREADS) {
            const int i = idx / N, j = idx % N;
            xs[idx] = i == j ? c0 : 0.0f;
        }
    }
    __syncthreads();

    // 4. the rest of the schedule: X <- X ((2a) I - a^2 M_b X); scenarios
    //    that accepted their warm start run plain Newton (a = 1)
    for (int k = start; k < n_coeffs; ++k) {
        const float aa = (warm && ok) ? 1.0f : sched.a[k];
        tile_product(mb, xs, ty, tx, acc);
        store_step_factor(tm, ty, tx, acc, aa);
        __syncthreads();
        tile_product(xs, tm, ty, tx, acc);
        __syncthreads();
        store_tile(xs, ty, tx, acc);
        __syncthreads();
    }

    // 5. unbalance: M^-1 = S X S
    float* ob = out + (size_t)b * N * N;
    for (int idx = tid; idx < N * N; idx += NTHREADS) {
        const int i = idx / N, j = idx % N;
        ob[idx] = xs[idx] * (sv[i] * sv[j]);
    }
}

}  // namespace

extern "C" int kkt_schulz_launch(const float* tiled, const float* dmain,
                                 const float* off1, const float* off2,
                                 const float* cost, const float* coef,
                                 const float* x0, float* out,
                                 const float* coeffs, int n_coeffs,
                                 int batch, cudaStream_t stream) {
    if (n_coeffs < 1 || n_coeffs > MAX_COEFFS) return (int)cudaErrorInvalidValue;
    static bool configured = false;
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(
            kkt_schulz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)SMEM_BYTES);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    Schedule sched;
    for (int k = 0; k < MAX_COEFFS; ++k) sched.a[k] = k < n_coeffs ? coeffs[k] : 1.0f;
    kkt_schulz_kernel<<<batch, NTHREADS, SMEM_BYTES, stream>>>(
        tiled, dmain, off1, off2, cost, coef, x0, out, sched, n_coeffs);
    return (int)cudaGetLastError();
}
