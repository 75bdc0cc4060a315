// K1: fused KKT build + Jacobi balance + basin-safeguarded (scaled)
// Newton-Schulz inverse, per scenario, for sm_90a.
//
// Replaces the TPU kernel go1_qp_mpc_controller_tpu/ops/pallas_admm.py
// schulz_inverse_kkt_batch (_schulz_kkt_kernel = _kkt_build_tile +
// _schulz_batch_body). The plain PyTorch version of the same function is
// ops/kkt_schulz.py::kkt_schulz_plain (with ``middle_matmul=
// matmul_3xtf32``, the emulation of the tensor-core routes' middle steps).
//
// What bounds it on an H100: operations. A Schulz step is two 120x120x120
// products (6.9 MFLOP) on a matrix that never leaves the SM, against 24 KB
// of lazy factors and 58 KB of warm start read and 58 KB of inverse
// written per scenario: at batch 4096 the one-step warm tick is 28 GFLOP
// of FP32 against 0.57 GB (0.42 ms at the FP32 FMA peak vs 0.17 ms of
// HBM); a 9-step cold schedule is 8x the products, most of them 3xTF32.
//
// Precision schedule (the TPU's): the middle steps (k < n_coeffs -
// hi_tail, the TPU's bf16x3) run 3xTF32 on the tensor cores; the last
// hi_tail steps, the basin test and the accepted warm step run FP32 FMA
// (the TPU's HIGHEST). Two routes, which the wrapper picks by schedule
// (ops/kkt_schulz.py::route):
//
//   - "cta": a schedule with a 3xTF32 step, at any batch.
//     schulz_tc.cuh's one-block body (wgmma middles, 256 threads; 225 KB:
//     M_b, X and T of 64 KB each and a ring of four 8 KB hi / lo slabs of
//     B, A going to the tensor cores from registers) on M built straight
//     into its padded 128 x 128 swizzled slot by KktSource as it
//     balances: the factors are read from global memory with
//     j-contiguous (coalesced) loads, a thread holding one column's
//     quadrant entries in registers, h and x taken from loop indices. The
//     225 KB leave no room to stage them. (schulz_tc.cuh's cluster body
//     is not used: no path sends K1 a 3xTF32 schedule at the small batches
//     where it would pay; one-robot cold solves go through K3.)
//   - "fp32": a schedule without a 3xTF32 step (the steady warm tick's one
//     refinement step), at any batch. One 400-thread block a scenario on
//     schulz_body.cuh's FP32 schedule: at block start one thread stages
//     the lazy factors (23 KB) and the warm start (57.6 KB) into shared
//     memory with bulk asynchronous copies (cp.async.bulk + mbarrier), so
//     the HBM reads overlap the build and the balance; M_b is built from
//     the staged factors with no per-entry division, the warm start is
//     balanced in place, and the unbalanced inverse leaves with coalesced
//     float4 stores. 198 KB a block. Persistent blocks that prefetch the
//     next scenario's operands while this one computes read slower on the
//     H100 (the loop's extra live state cost registers and spills, and the
//     prefetch hid little), so each scenario has its block.
//
// The TPU's 120 -> 128 padding is kept only by the tensor-core routes
// (their tiles); the identity-padded block changes neither the inf-norm
// scale nor the iterates.

#include <cuda_runtime.h>
#include <stdint.h>

#include "schulz_body.cuh"
#include "schulz_tc.cuh"

namespace {

using schulz_tc::NP;
using schulz_tc::Route;

constexpr int N = 120;           // decision variables (H * NU)
constexpr int NU = 12;           // forces per horizon step
constexpr int NSTEP = 10;        // horizon
constexpr int TD = 20;           // "fp32": thread grid TD x TD, 6 x 6 each
using Tile = schulz::Tile<N, TD>;

// M[i, j] = cost sum_k coef[k, h, j] tiled[k, x, j] + band(i, j) with
// i = 12 h + x (srb.lazy_hessian semantics). The diagonal pass and the
// build both go through here, so s = diag(M)^-1/2 sees the same bits.
__device__ __forceinline__ float kkt_entry(const float (&c)[4], float t0,
                                           float t1, float t2, float t3,
                                           float cost, float band) {
    float acc = c[0] * t0;
    acc = fmaf(c[1], t1, acc);
    acc = fmaf(c[2], t2, acc);
    acc = fmaf(c[3], t3, acc);
    return fmaf(cost, acc, band);
}

// The symmetric band at (i, j): dmain on the diagonal, off1 at +-1 and off2
// at +-2, each stored at the smaller index.
__device__ __forceinline__ float band_at(const float* dm, const float* o1,
                                         const float* o2, int i, int j) {
    const int d = i - j;
    return d == 0 ? dm[i] : d == 1 ? o1[j] : d == -1 ? o1[i]
         : d == 2 ? o2[j] : d == -2 ? o2[i] : 0.0f;
}

__device__ __forceinline__ void load_coef(const float* __restrict__ coef,
                                          int h, int j, float (&c)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = __ldg(coef + (k * NSTEP + h) * N + j);
}

// M's diagonal entry i from the factors `tb` (4, 12, N) and the band.
__device__ __forceinline__ float kkt_diag(const float* tb,
                                          const float* __restrict__ coef,
                                          const float* dm, float cost,
                                          int i) {
    const int h = i / NU, x = i - NU * h;
    float c[4];
    load_coef(coef, h, i, c);
    return kkt_entry(c, tb[(0 * NU + x) * N + i], tb[(1 * NU + x) * N + i],
                     tb[(2 * NU + x) * N + i], tb[(3 * NU + x) * N + i],
                     cost, dm[i]);
}

// The tensor-core routes' matrix source (schulz_tc.cuh's DenseSource
// interface): M_b = S M S assembled from the scenario's lazy factors in
// global memory into the padded swizzled slot, by the 256 threads of a
// block. Thread (j, half) = (tid % 128, tid / 128) owns column j's rows
// 12 h + half + 2 q (q = 0..5): its 24 quadrant entries are loaded once
// (coalesced over j), then each h takes 4 coefficients and writes 6 rows.
struct KktSource {
    const float* tb;                  // (4, 12, N)
    const float* dm;                  // (N,) each
    const float* o1;
    const float* o2;
    const float* coef;                // (4, NSTEP, N)
    float cost;

    template <bool BALANCE>
    __device__ void build(int, float* mb, float* sv) const {
        static_assert(BALANCE, "K1 always balances");
        static_assert(schulz_tc::NTHREADS == 2 * NP, "two threads a column");
        const int tid = threadIdx.x;
        if (tid < NP)
            sv[tid] = tid < N ? rsqrtf(kkt_diag(tb, coef, dm, cost, tid))
                              : 1.0f;
        __syncthreads();
        const int j = tid & (NP - 1), half = tid >> 7;
        if (j < N) {
            float t[4][6];
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int q = 0; q < 6; ++q)
                    t[k][q] = tb[(k * NU + half + 2 * q) * N + j];
            const float sj = sv[j];
#pragma unroll 2
            for (int h = 0; h < NSTEP; ++h) {
                float c[4];
                load_coef(coef, h, j, c);
#pragma unroll
                for (int q = 0; q < 6; ++q) {
                    const int i = NU * h + half + 2 * q;
                    const float v = kkt_entry(c, t[0][q], t[1][q], t[2][q],
                                              t[3][q], cost,
                                              band_at(dm, o1, o2, i, j));
                    mb[schulz_tc::swz(i, j)] = v * (sv[i] * sj);
                }
            }
            for (int i = N + half; i < NP; i += 2)
                mb[schulz_tc::swz(i, j)] = 0.0f;
        } else {
            for (int i = half; i < NP; i += 2)
                mb[schulz_tc::swz(i, j)] = i == j ? 1.0f : 0.0f;
        }
        __syncthreads();
    }
};

__device__ __forceinline__ KktSource scenario_source(
        const float* tiled, const float* dmain, const float* off1,
        const float* off2, const float* cost, const float* coef, int b) {
    return KktSource{tiled + (size_t)b * 4 * NU * N, dmain + (size_t)b * N,
                     off1 + (size_t)b * N, off2 + (size_t)b * N, coef,
                     cost[b]};
}

// "cta": block b inverts scenario b
__global__ void __launch_bounds__(schulz_tc::NTHREADS, 1)
kkt_tc_cta_kernel(const float* __restrict__ tiled,   // (B, 4, 12, N)
                  const float* __restrict__ dmain,   // (B, N)
                  const float* __restrict__ off1,    // (B, N)
                  const float* __restrict__ off2,    // (B, N)
                  const float* __restrict__ cost,    // (B,)
                  const float* __restrict__ coef,    // (4, 10, N)
                  const float* __restrict__ x0,      // (B, N, N) or null
                  float* __restrict__ out,           // (B, N, N)
                  schulz::Schedule sched, int n_coeffs, int hi_tail) {
    extern __shared__ float4 smem4[];
    const int b = blockIdx.x;
    const size_t off = (size_t)b * N * N;
    schulz_tc::tc_schulz<false, true>(
        reinterpret_cast<float*>(smem4), 0,
        scenario_source(tiled, dmain, off1, off2, cost, coef, b),
        x0 != nullptr ? x0 + off : nullptr, N, sched, n_coeffs, hi_tail,
        out + off);
}

// ---- "fp32": bulk-staged operands on the FP32 body ----

// Shared memory of the "fp32" route (bytes): schulz_body.cuh's M_b, X,
// scratch, s and reduction scratch, then the staged factors (tiled, then
// dmain, off1, off2) and two mbarriers (factors, warm start).
struct Fp32Smem {
    static constexpr size_t TILED = Tile::SMEM_BYTES;
    static constexpr size_t TILED_BYTES = 4 * NU * N * sizeof(float);
    static constexpr size_t BAND = TILED + TILED_BYTES;
    static constexpr size_t BAND_BYTES = N * sizeof(float);   // each
    static constexpr size_t BAR = BAND + 3 * BAND_BYTES;
    static constexpr size_t BYTES = BAR + 2 * sizeof(uint64_t);
    static_assert(TILED % 16 == 0 && BAND % 16 == 0 && BAR % 8 == 0,
                  "bulk copies need 16-byte aligned destinations");
    static_assert(BYTES <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// the one arrival, announcing `bytes` of copies that complete the phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

// global -> shared bulk copy of `bytes` (a multiple of 16, both ends
// 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

__global__ void __launch_bounds__(Tile::NTHREADS, 1)
kkt_fp32_kernel(const float* __restrict__ tiled,
                const float* __restrict__ dmain,
                const float* __restrict__ off1,
                const float* __restrict__ off2,
                const float* __restrict__ cost,
                const float* __restrict__ coef,
                const float* __restrict__ x0,
                float* __restrict__ out,
                schulz::Schedule sched, int n_coeffs) {
    extern __shared__ __align__(16) float smem[];
    char* base = reinterpret_cast<char*>(smem);
    float* mb = smem;
    float* xs = mb + N * N;
    float* tm = xs + N * N;
    float* sv = tm + N * N;
    float* st = reinterpret_cast<float*>(base + Fp32Smem::TILED);
    float* sdm = reinterpret_cast<float*>(base + Fp32Smem::BAND);
    float* so1 = sdm + N;
    float* so2 = so1 + N;
    uint64_t* bar = reinterpret_cast<uint64_t*>(base + Fp32Smem::BAR);
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const bool warm = x0 != nullptr;

    if (tid == 0) {
        mbar_init(bar);
        mbar_init(bar + 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        mbar_expect(bar, Fp32Smem::TILED_BYTES + 3 * Fp32Smem::BAND_BYTES);
        bulk_load(st, tiled + (size_t)b * 4 * NU * N, Fp32Smem::TILED_BYTES,
                  bar);
        bulk_load(sdm, dmain + (size_t)b * N, Fp32Smem::BAND_BYTES, bar);
        bulk_load(so1, off1 + (size_t)b * N, Fp32Smem::BAND_BYTES, bar);
        bulk_load(so2, off2 + (size_t)b * N, Fp32Smem::BAND_BYTES, bar);
        if (warm) {
            mbar_expect(bar + 1, N * N * sizeof(float));
            bulk_load(xs, x0 + (size_t)b * N * N, N * N * sizeof(float),
                      bar + 1);
        }
    }
    const float cst = cost[b];
    mbar_wait(bar, 0);

    // s = diag(M)^-1/2, then M_b: thread (rg, j) = (tid / N, tid % N),
    // tid < 3 N, owns column j's rows 12 h + rg + 3 q (q = 0..3)
    if (tid < N) sv[tid] = rsqrtf(kkt_diag(st, coef, sdm, cst, tid));
    __syncthreads();
    static_assert(Tile::NTHREADS >= 3 * N, "a thread per work item");
    if (tid < 3 * N) {
        const int rg = tid / N, j = tid - N * rg;
        float t[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int q = 0; q < 4; ++q)
                t[k][q] = st[(k * NU + rg + 3 * q) * N + j];
        const float sj = sv[j];
#pragma unroll 2
        for (int h = 0; h < NSTEP; ++h) {
            float c[4];
            load_coef(coef, h, j, c);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int i = NU * h + rg + 3 * q;
                const float v = kkt_entry(c, t[0][q], t[1][q], t[2][q],
                                          t[3][q], cst,
                                          band_at(sdm, so1, so2, i, j));
                mb[i * N + j] = v * (sv[i] * sj);
            }
        }
    }
    // the warm start, balanced in place: X0_b = X0 / (s_i s_j)
    if (warm) {
        mbar_wait(bar + 1, 0);
        float4* x4 = reinterpret_cast<float4*>(xs);
        for (int v = tid; v < N * N / 4; v += Tile::NTHREADS) {
            const int i = v / (N / 4), j = 4 * (v - (N / 4) * i);
            const float si = sv[i];
            float4 x = x4[v];
            x.x = x.x / (si * sv[j]);
            x.y = x.y / (si * sv[j + 1]);
            x.z = x.z / (si * sv[j + 2]);
            x.w = x.w / (si * sv[j + 3]);
            x4[v] = x;
        }
    }
    __syncthreads();

    schulz::schulz_core<N, TD>(mb, xs, tm, sv + N, warm, sched, n_coeffs);

    // unbalance M^-1 = S X S, coalesced float4 stores
    const float4* x4 = reinterpret_cast<const float4*>(xs);
    float4* o4 = reinterpret_cast<float4*>(out + (size_t)b * N * N);
    for (int v = tid; v < N * N / 4; v += Tile::NTHREADS) {
        const int i = v / (N / 4), j = 4 * (v - (N / 4) * i);
        const float si = sv[i];
        float4 x = x4[v];
        x.x = x.x * (si * sv[j]);
        x.y = x.y * (si * sv[j + 1]);
        x.z = x.z * (si * sv[j + 2]);
        x.w = x.w * (si * sv[j + 3]);
        o4[v] = x;
    }
}

int configure() {
    static int status = -1;
    if (status < 0) {
        int e = schulz_tc::allow_smem(kkt_tc_cta_kernel,
                                      Route<false>::SMEM_BYTES);
        if (e == 0)
            e = schulz_tc::allow_smem(kkt_fp32_kernel, Fp32Smem::BYTES);
        if (e != 0) return e;
        status = 0;
    }
    return status;
}

}  // namespace

// blocks: the route, as blocks per scenario: 0 "fp32" (FP32 body, staged
// operands), 1 "cta" (the one-block tensor-core route); any other value is
// refused with cudaErrorInvalidValue. hi_tail: the last steps that run FP32 on the
// tensor-core routes ("fp32" runs every step FP32). The "fp32" route
// needs 16-byte aligned tiled, dmain, off1, off2 and x0 (the wrapper
// checks).
extern "C" int kkt_schulz_launch(const float* tiled, const float* dmain,
                                 const float* off1, const float* off2,
                                 const float* cost, const float* coef,
                                 const float* x0, float* out,
                                 const float* coeffs, int n_coeffs,
                                 int hi_tail, int batch, int blocks,
                                 cudaStream_t stream) {
    if (n_coeffs < 1 || n_coeffs > schulz::MAX_COEFFS || hi_tail < 0
        || (blocks != 0 && blocks != 1))
        return (int)cudaErrorInvalidValue;
    const int e = configure();
    if (e != 0) return e;
    const schulz::Schedule sched = schulz::make_schedule(coeffs, n_coeffs);
    if (hi_tail > n_coeffs) hi_tail = n_coeffs;
    if (blocks == 0) {
        kkt_fp32_kernel<<<batch, Tile::NTHREADS, Fp32Smem::BYTES, stream>>>(
            tiled, dmain, off1, off2, cost, coef, x0, out, sched, n_coeffs);
        return (int)cudaGetLastError();
    }
    kkt_tc_cta_kernel<<<batch, schulz_tc::NTHREADS,
                        Route<false>::SMEM_BYTES, stream>>>(
        tiled, dmain, off1, off2, cost, coef, x0, out, sched, n_coeffs,
        hi_tail);
    return (int)cudaGetLastError();
}
