// The FP32 Schulz body shared by K1's "fp32" route (csrc/kkt_schulz.cu)
// and K3 at n = 12 and its n = 120 "fp32" route (csrc/schulz_batch.cu)
// (K4, csrc/schulz_lanes.cu, takes only its Schedule): Jacobi balance,
// basin-safeguarded (scaled) Newton-Schulz schedule and unbalance of one
// N x N matrix, run by one thread block. Counterpart of the TPU body
// go1_qp_mpc_controller_tpu/ops/pallas_admm.py::_schulz_batch_body; the
// plain PyTorch version is ops/kkt_schulz.py::schulz_balanced_plain.
// Schedules with a 3xTF32 step at n = 120 (K1, K3) and K5 run the
// tensor-core body of csrc/schulz_tc.cuh instead, which keeps this body's
// semantics (and its nan_min / nan_max).
//
// Layout: the balanced matrix M_b, the iterate X and the product scratch T
// live in dynamic shared memory (3 N^2 floats: 169 KB at N = 120, under the
// 227 KB a block may use), so the schedule touches device memory only for
// the warm start and the result. TD x TD threads own an RT x RT register
// tile each (rows ty + TD r, columns tx + TD c: a warp reads consecutive
// B columns and at most a few A rows; at N = 120 columns 4 tx .. 4 tx + 3
// and 80 + 2 tx, + 1, so a B row is read as a float4 and a float2); A is
// read as float4 along k. Every
// product is full FP32 FMA (the TPU's HIGHEST; this body runs only
// schedules without a bf16x3 step at n = 120, and at N = 12 and 28 an
// m16n8k8 tile would be mostly padding). What bounds it: FP32 FMA issue
// from shared memory at one 169 KB block per SM (N = 120), latency at the
// small sizes. The basin test's reductions are block-wide and propagate
// NaN like jnp.min / jnp.max. balanced_schulz balances a matrix already in
// shared memory; K1's "fp32" route balances as it builds and calls
// schulz_core itself.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace schulz {

constexpr int MAX_COEFFS = 64;

struct Schedule {
    float a[MAX_COEFFS];
};

// Thread tiling and shared-memory size for an N x N matrix on TD x TD
// threads.
template <int N, int TD>
struct Tile {
    static constexpr int RT = N / TD;
    static constexpr int NTHREADS = TD * TD;
    static constexpr int RWARPS = (N + 31) / 32;   // full warps over the rows
    static_assert(N % TD == 0, "the thread grid must tile the matrix");
    static_assert(N % 4 == 0, "rows are read as float4");
    static_assert(NTHREADS >= 32 * RWARPS, "row warps must be full");
    // M_b, X, T, the balance scale s, the reduction scratch
    static constexpr size_t SMEM_BYTES =
        (3 * N * N + N + 2 * RWARPS + 4) * sizeof(float);
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
template <int N, int TD>
__device__ void block_minmax(float lo, float hi, float* red, float* out_lo,
                             float* out_hi) {
    constexpr int RWARPS = Tile<N, TD>::RWARPS;
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

// column c of thread tx's tile: at N = 120 on 20 x 20 threads the first
// four columns are 4 tx .. 4 tx + 3 and the last two 80 + 2 tx, + 1 (B
// read as a float4 and a float2); otherwise tx + TD c
template <int N, int TD>
__device__ __forceinline__ int tile_col(int tx, int c) {
    if constexpr (N == 120 && TD == 20)
        return c < 4 ? 4 * tx + c : 80 + 2 * tx + (c - 4);
    else
        return tx + TD * c;
}

// acc = A @ B for the thread's RT x RT tile; A, B are N x N row-major in
// shared memory.
template <int N, int TD>
__device__ __forceinline__ void tile_product(
        const float* A, const float* B, int ty, int tx,
        float acc[Tile<N, TD>::RT][Tile<N, TD>::RT]) {
    constexpr int RT = Tile<N, TD>::RT;
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < RT; ++c) acc[r][c] = 0.0f;
    // two float4 steps of k per trip: more independent loads in flight
    // between the FMA chains (the body is latency bound)
#pragma unroll 2
    for (int k = 0; k < N; k += 4) {
        float4 a[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
            a[r] = *reinterpret_cast<const float4*>(A + (ty + TD * r) * N + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            float b[RT];
            if constexpr (N == 120 && TD == 20) {
                const float* brow = B + (k + kk) * N;
                const float4 b4 =
                    *reinterpret_cast<const float4*>(brow + 4 * tx);
                const float2 b2 =
                    *reinterpret_cast<const float2*>(brow + 80 + 2 * tx);
                b[0] = b4.x;
                b[1] = b4.y;
                b[2] = b4.z;
                b[3] = b4.w;
                b[4] = b2.x;
                b[5] = b2.y;
            } else {
#pragma unroll
                for (int c = 0; c < RT; ++c)
                    b[c] = B[(k + kk) * N + tx + TD * c];
            }
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
template <int N, int TD>
__device__ __forceinline__ void store_step_factor(
        float* T, int ty, int tx,
        float acc[Tile<N, TD>::RT][Tile<N, TD>::RT], float aa) {
    constexpr int RT = Tile<N, TD>::RT;
    const float two_a = 2.0f * aa;
    const float a2 = aa * aa;
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < RT; ++c) {
            const int i = ty + TD * r, j = tile_col<N, TD>(tx, c);
            T[i * N + j] = (i == j ? two_a : 0.0f) - a2 * acc[r][c];
        }
}

template <int N, int TD>
__device__ __forceinline__ void store_tile(
        float* X, int ty, int tx,
        float acc[Tile<N, TD>::RT][Tile<N, TD>::RT]) {
    constexpr int RT = Tile<N, TD>::RT;
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < RT; ++c)
            X[(ty + TD * r) * N + tile_col<N, TD>(tx, c)] = acc[r][c];
}

// The third N x N slot of the block's shared memory, where the caller
// puts the UNBALANCED matrix M before calling balanced_schulz.
template <int N>
__device__ __forceinline__ float* input_slot(float* smem) {
    return smem + 2 * N * N;
}

// The schedule on an already balanced matrix, all N x N in shared memory:
// on entry `mb` holds M_b and, with a warm start (`warm`), `xs` the
// balanced X0_b (both visible to every thread); `tm` is product scratch and
// `red` the reduction scratch. On exit `xs` holds the balanced X, every
// thread is past a barrier, and `tm` is free.
//   - c0 = 1 / (1.05 ||M_b||_inf);
//   - with a warm start: the basin test on M_b X0_b (min diagonal > 1e-4
//     and max absolute row sum < 3); an accepted start takes a plain
//     Newton step, a rejected one the scaled cold step; with an empty
//     schedule the result is X0_b or c0 I;
//   - without one: c0 I, its first step (scaled or plain) folded
//     analytically;
//   - then the rest of the schedule; scenarios that accepted their warm
//     start run plain Newton (a = 1).
template <int N, int TD>
__device__ __forceinline__ void schulz_core(const float* mb, float* xs,
                                            float* tm, float* red, bool warm,
                                            const Schedule& sched,
                                            int n_coeffs) {
    using T = Tile<N, TD>;
    constexpr int RT = T::RT;
    constexpr int NTHREADS = T::NTHREADS;
    const int tid = threadIdx.x;
    const int ty = tid / TD, tx = tid % TD;

    float row = 0.0f;
    if (tid < N)
        for (int j = 0; j < N; ++j) row += fabsf(mb[tid * N + j]);
    float unused, norminf;
    block_minmax<N, TD>(INFINITY, tid < N ? row : -INFINITY, red, &unused,
                        &norminf);
    const float c0 = 1.0f / (1.05f * norminf);

    float acc[RT][RT];
    int start = 0;
    bool ok = false;
    if (warm) {
        // basin test on M_b X0_b, shared with the first Newton step
        tile_product<N, TD>(mb, xs, ty, tx, acc);
        store_tile<N, TD>(tm, ty, tx, acc);          // tm = M_b X0_b
        __syncthreads();
        float d = INFINITY, rs = -INFINITY;
        if (tid < N) {
            d = tm[tid * N + tid];
            rs = 0.0f;
            for (int j = 0; j < N; ++j) rs += fabsf(tm[tid * N + j]);
        }
        float dmin, rmax;
        block_minmax<N, TD>(d, rs, red, &dmin, &rmax);  // ends in a barrier
        ok = (dmin > 1e-4f) && (rmax < 3.0f);
        if (n_coeffs == 0) {
            // empty schedule: the accepted start as it is, else c0 I
            if (!ok)
                for (int idx = tid; idx < N * N; idx += NTHREADS) {
                    const int i = idx / N, j = idx % N;
                    xs[idx] = i == j ? c0 : 0.0f;
                }
        } else if (ok) {
            store_step_factor<N, TD>(tm, ty, tx, acc, 1.0f);  // 2I - M_b X0_b
            __syncthreads();
            tile_product<N, TD>(xs, tm, ty, tx, acc);  // X0_b (2I - M_b X0_b)
            __syncthreads();
            store_tile<N, TD>(xs, ty, tx, acc);
        } else {
            const float ac = sched.a[0] * c0;        // scaled cold step
            for (int idx = tid; idx < N * N; idx += NTHREADS) {
                const int i = idx / N, j = idx % N;
                xs[idx] = ac * ((i == j ? 2.0f : 0.0f) - ac * mb[idx]);
            }
        }
        start = 1;
    } else if (n_coeffs > 0) {
        // the first step from the scalar cold init c0 I, folded (exact for
        // any a, the plain a = 1 included): no product
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

    // the rest of the schedule: X <- X ((2a) I - a^2 M_b X)
    for (int k = start; k < n_coeffs; ++k) {
        const float aa = (warm && ok) ? 1.0f : sched.a[k];
        tile_product<N, TD>(mb, xs, ty, tx, acc);
        store_step_factor<N, TD>(tm, ty, tx, acc, aa);
        __syncthreads();
        tile_product<N, TD>(xs, tm, ty, tx, acc);
        __syncthreads();
        store_tile<N, TD>(xs, ty, tx, acc);
        __syncthreads();
    }
}

// On entry input_slot(smem) holds the unbalanced M of this block's
// scenario (visible to every thread). Computes the basin-safeguarded
// (scaled) Newton-Schulz inverse (schulz_core) of M_b = S M S with
// S = diag(M)^-1/2, from the unbalanced warm start x0 (or null), and
// writes the unbalanced S X S to `out`.
template <int N, int TD>
__device__ __forceinline__ void balanced_schulz(
        float* smem, const float* __restrict__ x0, const Schedule& sched,
        int n_coeffs, float* __restrict__ out) {
    constexpr int NTHREADS = Tile<N, TD>::NTHREADS;
    float* mb = smem;               // balanced M_b
    float* xs = mb + N * N;         // iterate X (balanced)
    float* tm = xs + N * N;         // the input M, then product scratch
    float* sv = tm + N * N;         // balance scale s = diag(M)^-1/2

    const int tid = threadIdx.x;
    const bool warm = x0 != nullptr;

    // Jacobi balance M_b = M * s_i s_j
    if (tid < N) sv[tid] = rsqrtf(tm[tid * N + tid]);
    __syncthreads();
    for (int idx = tid; idx < N * N; idx += NTHREADS) {
        const int i = idx / N, j = idx % N;
        mb[idx] = tm[idx] * (sv[i] * sv[j]);
        if (warm) xs[idx] = x0[idx] / (sv[i] * sv[j]);
    }
    __syncthreads();
    schulz_core<N, TD>(mb, xs, tm, sv + N, warm, sched, n_coeffs);

    // unbalance: M^-1 = S X S
    for (int idx = tid; idx < N * N; idx += NTHREADS) {
        const int i = idx / N, j = idx % N;
        out[idx] = xs[idx] * (sv[i] * sv[j]);
    }
}

// Copy a host schedule into the by-value kernel argument (unused slots 1).
inline Schedule make_schedule(const float* coeffs, int n_coeffs) {
    Schedule s;
    for (int k = 0; k < MAX_COEFFS; ++k)
        s.a[k] = k < n_coeffs ? coeffs[k] : 1.0f;
    return s;
}

}  // namespace schulz
