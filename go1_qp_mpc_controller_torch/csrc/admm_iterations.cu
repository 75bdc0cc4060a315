// K6: the fixed-iteration ADMM loop of the warm MPC tick with the KKT
// inverse held in registers, a persistent grid of 160-thread blocks, for
// sm_90a.
//
// Replaces the TPU kernel go1_qp_mpc_controller_tpu/ops/pallas_admm.py
// admm_iterations (_kernel). The plain PyTorch version of the same
// function is ops/admm_iterations.py::admm_iterations_plain (the port's
// ADMM loop, ops/admm.py::_admm_iterations, on the friction pyramid).
//
// Per scenario, from (x0, z0, y0) (z0 = clip(C x0, lb, ub) when no z0 is
// given: the warm tick's start) and with w = rho z - y:
//   rhs = sigma x - qbar + C' w;  x_t = Minv rhs;  z_t = C x_t
//   x <- alpha x_t + (1 - alpha) x;  z_mid = alpha z_t + (1 - alpha) z
//   z <- clip(z_mid + y / rho, lb, ub);  y <- y + rho (z_mid - z)
// C is the friction pyramid: per (step, leg) pair p the 5 rows
// 5p .. 5p + 4 (fx + mu fz, fx - mu fz, fy + mu fz, fy - mu fz, fz) of the
// 3 variables 3p .. 3p + 2. The quotient y / rho is the correctly
// rounded one, as the plain loop's, computed without a division in the
// loop: q0 = y (1 / rho) with the reciprocal rounded once a scenario, then
// one Markstein correction q = q0 + (y - rho q0) (1 / rho) in two FMAs,
// which rounds to y / rho whenever the quotient is a normal float
// (tests/test_torch_k3_k6.py checks the sequence).
//
// What bounds it on an H100: bytes. An iteration is one 120 x 120 matvec
// (28.8 kFLOP) plus ~4 kFLOP of pyramid and projection work per scenario;
// the inverse (57.6 KB) is read once for the whole loop. At batch 4096 and
// 20 iterations: ~2.6 GFLOP (0.04 ms at the FP32 peak) against ~0.26 GB
// (0.08 ms of HBM).
//
// What the design does about it:
//   - The inverse lives in registers for the whole loop, so no iteration
//     reads it from shared memory. Five warps; warp w owns the pairs
//     8w .. 8w + 7, that is rows 24w .. 24w + 23 of Minv. Lane
//     (pair-in-warp, k-group g of 4) holds Minv[3p + i][30 g + j] for
//     i < 3, j < 30 (90 floats) and sums its 30 terms of each of the
//     pair's 3 rows in four interleaved FMA chains (j mod 4); two
//     __shfl_xor_sync add the 4 k-group partial sums in a tree, after
//     which every lane of the pair has the pair's x_t (the same bits in
//     each). The loop amplifies round-off, so the order matters: 16
//     chains of 7 or 8 under a tree stay closer to the float64 loop than
//     the former design's 8 chains of 15. The rhs entries of a k-group
//     are broadcast float4 shared loads (a k-group's entries 16-byte
//     aligned, the 4 groups in distinct banks), each used for 12 FMAs.
//   - Lanes g < 3 of a pair own its variables (x, qbar), lane g its
//     constraint row g and lane 3 also row 4 (z, y, lb, ub, rho); the
//     projection, the dual update and C'w are pair-local, so the only
//     block barrier of an iteration publishes rhs, which is
//     double-buffered so that the next iteration's writes never meet this
//     one's reads. Few warps a scenario keep the per-warp work of an
//     iteration (shuffles, the update, the barrier) small against its
//     FMAs; three blocks share an SM.
//   - The grid is persistent (the resident blocks of the card, at most
//     one a scenario). Each block loops over scenarios b, b + grid, ...;
//     one thread stages the next scenario's inverse, one contiguous 57.6
//     KB slab, into shared memory with cp.async.bulk on an mbarrier while
//     the current scenario iterates from registers, so the HBM read
//     overlaps the loop. The staged slab is read into registers once a
//     scenario.
// Nothing but x, z and y is written back. The clip propagates NaN like
// torch.clamp, so a diverged scenario reaches the caller's non-finite
// latch; a scenario's state never leaves its block's registers, so a NaN
// stays in its scenario.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NV = 120;          // decision variables
constexpr int NC = 200;          // constraint rows
constexpr int WARPS = 5;
constexpr int NT = 32 * WARPS;
constexpr int PAIRS_PER_WARP = 8;
constexpr int KG = 4;            // k-groups: the lanes of a pair
constexpr int KL = NV / KG;      // k entries a lane holds per row
static_assert(WARPS * PAIRS_PER_WARP * 3 == NV, "one pair per 4 lanes");
static_assert(PAIRS_PER_WARP * KG == 32, "a warp is 8 pairs x 4 k-groups");
static_assert(KG * KL == NV && KL % 4 == 2, "the k-groups tile the row");
// rhs in shared memory: k-group g's 30 entries at RS g, 16-byte aligned
// and 4 banks apart (float4 reads of the 4 groups hit distinct banks)
constexpr int RS = 36;
constexpr uint32_t MINV_BYTES = NV * NV * sizeof(float);
// the staged inverse, two rhs buffers, the threads' row constants (lb, ub,
// rho, 1 / rho: every thread's row a, then every thread's row b), the
// mbarrier
constexpr size_t RHS_OFF = MINV_BYTES;
constexpr size_t ROWK_OFF = RHS_OFF + 2 * KG * RS * sizeof(float);
constexpr size_t BAR_OFF = ROWK_OFF + 2 * NT * sizeof(float4);
constexpr size_t SMEM_BYTES = BAR_OFF + sizeof(uint64_t);
static_assert(RHS_OFF % 16 == 0 && ROWK_OFF % 16 == 0 && BAR_OFF % 8 == 0,
              "smem alignment");

__device__ __forceinline__ float clip(float v, float lo, float hi) {
    v = v < lo ? lo : v;          // NaN stays NaN, as in torch.clamp
    return v > hi ? hi : v;
}

// Row k < 4 of C applied to the pair's (fx, fy, fz): fx + mu fz,
// fx - mu fz, fy + mu fz, fy - mu fz (row 4 is fz itself); no branch.
__device__ __forceinline__ float pyramid_row(int k, float fx, float fy,
                                             float fz, float mu) {
    const float mfz = mu * fz;
    const float f = k < 2 ? fx : fy;
    return (k & 1) ? f - mfz : f + mfz;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(bar)) : "memory");
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

// One thread: stage scenario b's inverse (16-byte aligned, checked by the
// wrapper) into `dst`, completing the barrier's phase. The fence orders
// the block's earlier reads of `dst` before the asynchronous write.
__device__ __forceinline__ void stage_minv(float* dst, const float* src,
                                           uint64_t* bar) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(MINV_BYTES) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(MINV_BYTES),
           "r"(smem_u32(bar))
        : "memory");
}

// One constraint row's relaxation, projection and dual update; returns
// w = rho z - y. y / rho from the reciprocal and one correction.
__device__ __forceinline__ float row_update(float zt, float alpha,
                                            float beta, float lo, float hi,
                                            float rho, float rinv, float& z,
                                            float& y) {
    const float zmid = alpha * zt + beta * z;
    const float q0 = y * rinv;
    const float q = fmaf(fmaf(-rho, q0, y), rinv, q0);
    z = clip(zmid + q, lo, hi);
    y = y + rho * (zmid - z);
    return rho * z - y;
}

__global__ void __launch_bounds__(NT, 3)
admm_iterations_kernel(const float* __restrict__ minv,   // (B, NV, NV)
                       const float* __restrict__ qbar,   // (B, NV)
                       const float* __restrict__ lb,     // (B, NC)
                       const float* __restrict__ ub,     // (B, NC)
                       const float* __restrict__ rho,    // (B, NC)
                       const float* __restrict__ mu,     // (B,)
                       const float* __restrict__ x0,     // (B, NV)
                       const float* __restrict__ z0,     // (B, NC) or null
                       const float* __restrict__ y0,     // (B, NC)
                       float* __restrict__ x_out,        // (B, NV)
                       float* __restrict__ z_out,        // (B, NC)
                       float* __restrict__ y_out,        // (B, NC)
                       int iters, float alpha, float sigma, int batch) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* ms = reinterpret_cast<float*>(smem);               // staged Minv
    float* rhs = reinterpret_cast<float*>(smem + RHS_OFF);    // 2 x KG RS
    // the thread's row constants, read back each iteration by the same
    // thread (no barrier needed): 8 registers fewer, so 3 blocks fit an
    // SM with no spill
    float4* rowk = reinterpret_cast<float4*>(smem + ROWK_OFF) + threadIdx.x;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + BAR_OFF);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int g = lane & (KG - 1);              // k-group, role in the pair
    const int lead = lane & ~(KG - 1);          // the pair's lane 0
    const int pair = PAIRS_PER_WARP * (tid >> 5) + (lane >> 2);
    const int v = 3 * pair + g;                 // variable of lanes g < 3
    const int vs = RS * (v / KL) + v % KL;      // its slot in rhs
    const int ra = 5 * pair + g;                // row g of the pair
    const int rb = 5 * pair + 4;                // its fz row, on lane 3
    const bool owns_v = g < 3, owns_b = g == KG - 1;
    const float beta = 1.0f - alpha;

    if (tid == 0) {
        mbar_init(bar);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0 && blockIdx.x < batch)
        stage_minv(ms, minv + (size_t)blockIdx.x * NV * NV, bar);

    uint32_t parity = 0;
    for (int b = blockIdx.x; b < batch; b += gridDim.x) {
        // this scenario's vectors, loads issued before the wait
        const float m = mu[b];
        float xj = 0.0f, qj = 0.0f;
        if (owns_v) {
            xj = x0[(size_t)b * NV + v];
            qj = qbar[(size_t)b * NV + v];
        }
        const size_t oa = (size_t)b * NC + ra, ob = (size_t)b * NC + rb;
        // lb, ub, rho, 1 / rho of row a and (lane 3) row b
        float4 ka = make_float4(lb[oa], ub[oa], rho[oa], 0.0f);
        ka.w = 1.0f / ka.z;
        float ya = y0[oa], za = z0 != nullptr ? z0[oa] : 0.0f;
        float4 kb = make_float4(0.0f, 0.0f, 1.0f, 1.0f);
        float yb = 0.0f, zb = 0.0f;
        if (owns_b) {
            kb.x = lb[ob];
            kb.y = ub[ob];
            kb.z = rho[ob];
            kb.w = 1.0f / kb.z;
            yb = y0[ob];
            if (z0 != nullptr) zb = z0[ob];
        }
        rowk[0] = ka;
        rowk[NT] = kb;

        // the inverse's tile into registers; then the slot takes the next
        // scenario's inverse while this one iterates
        mbar_wait(bar, parity);
        parity ^= 1u;
        float mr[3][KL];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < KL; ++j)
                mr[i][j] = ms[(3 * pair + i) * NV + KL * g + j];
        __syncthreads();
        if (tid == 0 && b + (int)gridDim.x < batch)
            stage_minv(ms, minv + (size_t)(b + gridDim.x) * NV * NV, bar);

        if (z0 == nullptr) {
            const float f0 = __shfl_sync(0xffffffffu, xj, lead);
            const float f1 = __shfl_sync(0xffffffffu, xj, lead + 1);
            const float f2 = __shfl_sync(0xffffffffu, xj, lead + 2);
            za = clip(pyramid_row(g, f0, f1, f2, m), ka.x, ka.y);
            zb = clip(f2, kb.x, kb.y);
        }
        float wa = ka.z * za - ya, wb = kb.z * zb - yb;

        for (int it = 0; it < iters; ++it) {
            // rhs = sigma x - qbar + C' w, published for every warp
            const float w0 = __shfl_sync(0xffffffffu, wa, lead);
            const float w1 = __shfl_sync(0xffffffffu, wa, lead + 1);
            const float w2 = __shfl_sync(0xffffffffu, wa, lead + 2);
            const float w3 = __shfl_sync(0xffffffffu, wa, lead + 3);
            const float w4 = __shfl_sync(0xffffffffu, wb, lead + 3);
            float* rb_ = rhs + (it & 1) * KG * RS;
            if (owns_v) {
                const float ctw = g == 0 ? w0 + w1
                                : g == 1 ? w2 + w3
                                         : m * (w0 - w1 + w2 - w3) + w4;
                rb_[vs] = sigma * xj - qj + ctw;
            }
            __syncthreads();
            // x_t = Minv rhs: the k-group's 30 terms of each row in four
            // interleaved chains (j mod 4), then the k-groups' tree
            const float* rk = rb_ + RS * g;
            float a[3][4] = {};
#pragma unroll
            for (int j = 0; j < KL - 2; j += 4) {
                const float4 r4 = *reinterpret_cast<const float4*>(rk + j);
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                    a[i][0] = fmaf(mr[i][j], r4.x, a[i][0]);
                    a[i][1] = fmaf(mr[i][j + 1], r4.y, a[i][1]);
                    a[i][2] = fmaf(mr[i][j + 2], r4.z, a[i][2]);
                    a[i][3] = fmaf(mr[i][j + 3], r4.w, a[i][3]);
                }
            }
            const float2 r2 = *reinterpret_cast<const float2*>(rk + KL - 2);
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                a[i][0] = fmaf(mr[i][KL - 2], r2.x, a[i][0]);
                a[i][1] = fmaf(mr[i][KL - 1], r2.y, a[i][1]);
            }
            float t0 = (a[0][0] + a[0][1]) + (a[0][2] + a[0][3]);
            float t1 = (a[1][0] + a[1][1]) + (a[1][2] + a[1][3]);
            float t2 = (a[2][0] + a[2][1]) + (a[2][2] + a[2][3]);
#pragma unroll
            for (int off = 1; off < KG; off <<= 1) {
                t0 += __shfl_xor_sync(0xffffffffu, t0, off);
                t1 += __shfl_xor_sync(0xffffffffu, t1, off);
                t2 += __shfl_xor_sync(0xffffffffu, t2, off);
            }
            if (owns_v) {
                const float xt = g == 0 ? t0 : g == 1 ? t1 : t2;
                xj = alpha * xt + beta * xj;
            }
            const float4 ca = rowk[0], cb = rowk[NT];
            wa = row_update(pyramid_row(g, t0, t1, t2, m), alpha, beta, ca.x,
                            ca.y, ca.z, ca.w, za, ya);
            wb = row_update(t2, alpha, beta, cb.x, cb.y, cb.z, cb.w, zb, yb);
        }
        if (owns_v) x_out[(size_t)b * NV + v] = xj;
        z_out[oa] = za;
        y_out[oa] = ya;
        if (owns_b) {
            z_out[ob] = zb;
            y_out[ob] = yb;
        }
    }
}

// Allow the kernel its dynamic shared memory (above the 48 KB default),
// once.
cudaError_t configure() {
    static cudaError_t e = cudaFuncSetAttribute(
        admm_iterations_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    return e;
}

}  // namespace

// Resident blocks of the kernel on one SM (the persistent grid is this
// times the SM count); negative: minus a CUDA error code.
extern "C" int admm_iterations_blocks_per_sm() {
    cudaError_t e = configure();
    if (e != cudaSuccess) return -(int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, admm_iterations_kernel, NT, SMEM_BYTES);
    return e != cudaSuccess ? -(int)e : blocks;
}

// `grid` persistent blocks (1 .. batch) over `batch` scenarios; `minv`
// must be 16-byte aligned (the bulk copies).
extern "C" int admm_iterations_launch(const float* minv, const float* qbar,
                                      const float* lb, const float* ub,
                                      const float* rho, const float* mu,
                                      const float* x0, const float* z0,
                                      const float* y0, float* x_out,
                                      float* z_out, float* y_out, int iters,
                                      float alpha, float sigma, int batch,
                                      int grid, cudaStream_t stream) {
    if (iters < 0 || grid < 1 || grid > batch ||
        reinterpret_cast<uintptr_t>(minv) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const cudaError_t e = configure();
    if (e != cudaSuccess) return (int)e;
    admm_iterations_kernel<<<grid, NT, SMEM_BYTES, stream>>>(
        minv, qbar, lb, ub, rho, mu, x0, z0, y0, x_out, z_out, y_out, iters,
        alpha, sigma, batch);
    return (int)cudaGetLastError();
}
