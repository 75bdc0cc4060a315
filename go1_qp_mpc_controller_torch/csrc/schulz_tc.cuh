// The tensor-core Schulz body of K3 at n = 120 (csrc/schulz_batch.cu), of
// K5 (csrc/schulz_balanced.cu) and of K1's schedules with a 3xTF32 step
// (csrc/kkt_schulz.cu, which builds M from the lazy factors: the body
// takes its matrix from a source, see DenseSource): Jacobi balance,
// basin-safeguarded (scaled) Newton-Schulz schedule and unbalance of one
// matrix padded to NP = 128, on one of two routes:
//
//   - the CTA route: one 256-thread block owns the whole matrix (K1 at
//     any batch, K3 above its crossover batch, one block per scenario);
//     its middle products are wgmma (WgProduct);
//   - the cluster route: a cluster of CLUSTER = 8 blocks owns one matrix,
//     block r the columns 16 r .. 16 r + 15 of every product (K5 always,
//     K3 up to the crossover, where one block per matrix would leave most
//     of the 132 SMs idle); its middle products are mma.sync on the
//     128 x 16 panel (TcPanel), below wgmma's sizes.
//
// Counterpart of the TPU body go1_qp_mpc_controller_tpu/ops/pallas_admm.py
// ::_schulz_batch_body (K3) and ::_schulz_kernel (K5). The plain PyTorch
// version is ops/kkt_schulz.py::schulz_balanced_core; with
// ``middle_matmul=kkt_schulz.matmul_3xtf32`` it also emulates the middle
// steps' 3xTF32 products.
//
// Precision schedule (the TPU's, carried over): the middle steps (step
// k < n_coeffs - hi_tail) run both products on the tensor cores as 3xTF32:
// each operand splits into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x -
// hi); lo*hi + hi*lo sum in one FP32 accumulator, hi*hi in another, and
// the small terms' sum is added to the large one at the end (product
// error ~1e-6 relative like the TPU's bf16x3; a single TF32 or bf16 pass
// diverges on the controller's KKTs). Every entry is split once per
// product: the CTA route splits A's fragments in registers and stages
// each k-slab of B as hi / lo copies, the cluster route its B panel. The
// basin test's product, the accepted warm step and the last hi_tail steps
// run FP32 FMA on the SIMT cores (the TPU's HIGHEST). Both routes sum
// every product entry in the same order, so they give the same bits.
//
// What bounds each route on an H100: the CTA route, each k-slab's three
// tensor-core passes, two of them chained on one accumulator, with B's
// split and staging and the block's barrier around them, then the FP32
// tail products and the load and balance; the cluster route, latency: 38
// dependent products for 20 cold steps, each step ending in an exchange
// of X's new columns and a cluster barrier.
//
// Padding: rows and columns n .. 127 hold an identity block in M_b and in
// a warm start. The products keep the block structure exactly (the
// off-diagonal pad entries stay 0), so the true block is what it would be
// unpadded; the reductions (inf-norm, basin test) run over the true rows.
//
// Layout: M_b, X and T live in dynamic shared memory, 128 floats a row,
// the column index XOR-ed with 4 p(row mod 8) (p a permutation of 0..7):
// the mma fragment loads of A (rows g, columns t), the staging reads and
// the float4 row reads of the SIMT product are then free of bank
// conflicts. The CTA route holds M_b, X, T (3 x 64 KB) and a ring of four
// 8 KB hi / lo slabs of B for wgmma (225 KB; A goes to the tensor cores
// from registers). A cluster block holds all of M_b and two buffers of X
// (3 x 64 KB), its 16-column panel of T and the hi / lo split of a B panel
// (3 x 8 KB, swizzled by pswz): the columns of T need only the block's
// columns of X, so a step exchanges once (cluster_schulz).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "schulz_body.cuh"

namespace schulz_tc {

namespace cg = cooperative_groups;

constexpr int NP = 128;                 // the padded matrix size
constexpr int NTHREADS = 256;           // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int CLUSTER = 8;              // blocks of one matrix (cluster route)
constexpr int PANEL = NP / CLUSTER;     // columns a cluster block owns
constexpr int SLAB = NP * 8;            // floats of a k-slab's hi or lo half
constexpr int RING = 4;                 // B slabs the CTA route stages

// Shared memory of a block on each route (floats, see the layouts in
// cta_schulz and cluster_schulz).
template <bool CL>
struct Route {
    static constexpr int CTA_FLOATS =
        3 * NP * NP + RING * 2 * SLAB + NP + 2 * NWARPS + 2;
    static constexpr int CLUSTER_FLOATS =
        3 * NP * NP + 3 * NP * PANEL + NP + 2 * NWARPS + 2 + 2 * CLUSTER
        + CLUSTER * NP;
    static constexpr size_t SMEM_BYTES =
        (size_t)(CL ? CLUSTER_FLOATS : CTA_FLOATS) * sizeof(float);
};

// offset of (i, j) in a swizzled 128-wide array
__device__ __forceinline__ int swz(int i, int j) {
    const int r = i & 7;
    const int p = ((r & 3) << 1) | (r >> 2);
    return i * NP + (j ^ (p << 2));
}

// offset of (k, j) in a swizzled 128 x 16 column panel: rows 2 and 3 of
// every 4 have their halves swapped, so the mma B fragment loads (rows
// k0 + t, columns g) hit 32 banks
__device__ __forceinline__ int pswz(int k, int j) {
    return k * PANEL + (j ^ (((k >> 1) & 1) << 3));
}

// B operands: a full swizzled array read from column col0, or a panel
struct FullB {
    const float* p;
    int col0;
    __device__ __forceinline__ float operator()(int k, int j) const {
        return p[swz(k, col0 + j)];
    }
    // B[k][col0 + j .. col0 + j + 3], j a multiple of 4
    __device__ __forceinline__ float4 quad(int k, int j) const {
        return *reinterpret_cast<const float4*>(p + swz(k, col0 + j));
    }
};
struct PanelB {
    const float* p;
    __device__ __forceinline__ float operator()(int k, int j) const {
        return p[pswz(k, j)];
    }
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo to ~2^-22 relative, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The cluster route's middle product: acc = A @ B[:, panel] for a block's
// 16-column panel (128 x 16, below wgmma's sizes), 3xTF32 with mma.sync.
// A is a full swizzled 128 x 128 array; warp w owns rows 16 w .. 16 w + 15
// and splits its own A fragments (no entry twice). The B panel, which
// every warp reads, is split once into hi / lo panels in `stage`.
struct TcPanel {
    float acc[2][4];     // hi * hi, then the result
    float accs[2][4];    // lo * hi + hi * lo

    template <class BA>
    __device__ __forceinline__ void run(const float* A, const BA& b,
                                        float* stage) {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int g = lane >> 2, t = lane & 3;
        uint32_t* b_hi = reinterpret_cast<uint32_t*>(stage);
        uint32_t* b_lo = b_hi + NP * PANEL;
        for (int idx = threadIdx.x; idx < NP * PANEL; idx += NTHREADS) {
            const int k = idx / PANEL, j = idx % PANEL;
            split(b(k, j), b_hi[pswz(k, j)], b_lo[pswz(k, j)]);
        }
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                acc[ni][e] = 0.0f;
                accs[ni][e] = 0.0f;
            }
        __syncthreads();
        const int r = 16 * warp + g;
#pragma unroll 4
        for (int k0 = 0; k0 < NP; k0 += 8) {
            uint32_t ah[4], al[4];
            split(A[swz(r, k0 + t)], ah[0], al[0]);
            split(A[swz(r + 8, k0 + t)], ah[1], al[1]);
            split(A[swz(r, k0 + t + 4)], ah[2], al[2]);
            split(A[swz(r + 8, k0 + t + 4)], ah[3], al[3]);
            uint32_t bh[2][2], bl[2][2];
#pragma unroll
            for (int ni = 0; ni < 2; ++ni) {
                const int c0 = pswz(k0 + t, 8 * ni + g);
                const int c1 = pswz(k0 + t + 4, 8 * ni + g);
                bh[ni][0] = b_hi[c0];
                bh[ni][1] = b_hi[c1];
                bl[ni][0] = b_lo[c0];
                bl[ni][1] = b_lo[c1];
            }
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
                mma_tf32(accs[ni], al, bh[ni][0], bh[ni][1]);
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
                mma_tf32(accs[ni], ah, bl[ni][0], bl[ni][1]);
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
                mma_tf32(acc[ni], ah, bh[ni][0], bh[ni][1]);
        }
        // the small terms' sum first, then hi * hi (matmul_3xtf32's order)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[ni][e] = accs[ni][e] + acc[ni][e];
    }

    // f(row, panel column, value) for every entry the thread holds
    template <class F>
    __device__ __forceinline__ void for_each(F f) const {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int i = 16 * warp + (lane >> 2), t = lane & 3;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
            const int j = 8 * ni + 2 * t;
            f(i, j, acc[ni][0]);
            f(i, j + 1, acc[ni][1]);
            f(i + 8, j, acc[ni][2]);
            f(i + 8, j + 1, acc[ni][3]);
        }
    }
};

// ---- the CTA route's middle product: wgmma ----
//
// A 128 x 128 product on the block's two warpgroups, warpgroup w owning
// rows 64 w .. 64 w + 63, in 16 k-slabs of 8, issued so that the tensor
// cores never drain inside a product:
//
//   - A from registers: each warp loads its own fragments of a slab (rows
//     g, g + 8 and columns t, t + 4 of its 16 rows; the swizzle makes these
//     loads conflict-free) and splits them into hi / lo there, so each
//     entry of A is read and split once and none of A is staged;
//   - B through a ring of RING slots of hi / lo copies (8 KB a slab): every
//     thread splits 4 entries of a slab (each entry once), which both
//     warpgroups' wgmmas read;
//   - per slab each warpgroup issues three wgmma.m64n128k8 (lo hi and hi lo
//     into one accumulator, hi hi into another, the two lo hi / hi lo
//     apart so that each waits less on the other), then, while they run,
//     splits the next slab of B into the next slot and waits only for the
//     previous slab's group (wait_group 1), so the tensor cores always
//     hold a slab; the next slab's A fragments are split once that wait
//     has freed their registers (two sets). The raw entries of both
//     operands are loaded two slabs ahead, so no shared-memory load waits
//     between an issue and the next. The block's barrier that ends a slab
//     publishes the staged slot and tells that both warpgroups retired
//     every slab before it, so the slot written during slab s (slab s - 3's)
//     is free.
//
// Staging layout: K-major without swizzle, as wgmma reads .tf32 operands:
// 8 x 4 core matrices of 128 contiguous bytes (row r, k-quad q at
// (r / 8) * SBO + q * LBO + (r % 8) * 16 bytes).
constexpr int STAGE_LBO = 128;          // bytes between the two k-quads
constexpr int STAGE_SBO = 256;          // bytes between 8-row groups

__device__ __forceinline__ uint64_t smem_desc(const float* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    return (uint64_t)((a >> 4) & 0x3FFF)
           | ((uint64_t)(STAGE_LBO >> 4) << 16)
           | ((uint64_t)(STAGE_SBO >> 4) << 32);
}

// d += A B for one 64 x 128 x 8 slab, A's fragment in registers (the
// mma.m16n8k8 layout on each warp's 16 rows), B in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulators while a wgmma owns them
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

struct WgProduct {
    float acc[64];     // hi * hi, then the result
    float accs[64];    // lo * hi + hi * lo

    // this thread's entries of B's slab k0: thread (r, q) = (tid % 128,
    // tid / 128) takes B[k0 + 4q .. k0 + 4q + 3][r]
    __device__ __forceinline__ static void load_b(const float* B, int k0,
                                                  float (&f)[4]) {
        const int r = threadIdx.x & (NP - 1), q = threadIdx.x >> 7;
#pragma unroll
        for (int e = 0; e < 4; ++e) f[e] = B[swz(k0 + 4 * q + e, r)];
    }

    // split them into a ring slot, hi then lo
    __device__ __forceinline__ static void store_b(const float (&f)[4],
                                                   float* slot) {
        const int r = threadIdx.x & (NP - 1), q = threadIdx.x >> 7;
        const int at = (r >> 3) * (STAGE_SBO / 4) + q * (STAGE_LBO / 4)
                       + (r & 7) * 4;
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(f[e], h[e], l[e]);
        *reinterpret_cast<uint4*>(slot + at) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(slot + SLAB + at) =
            make_uint4(l[0], l[1], l[2], l[3]);
    }

    // this thread's entries of A's fragment of slab k0: rows i, i + 8 (i =
    // 16 warp + g), columns k0 + t, k0 + t + 4
    __device__ __forceinline__ static void load_a(const float* A, int k0,
                                                  float (&f)[4]) {
        const int lane = threadIdx.x & 31;
        const int i = 16 * (threadIdx.x >> 5) + (lane >> 2), t = lane & 3;
        f[0] = A[swz(i, k0 + t)];
        f[1] = A[swz(i + 8, k0 + t)];
        f[2] = A[swz(i, k0 + t + 4)];
        f[3] = A[swz(i + 8, k0 + t + 4)];
    }

    __device__ __forceinline__ static void split_a(const float (&f)[4],
                                                   uint32_t (&hi)[4],
                                                   uint32_t (&lo)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) split(f[e], hi[e], lo[e]);
    }

    // slab s on A's fragment (ah, al) and its ring slot; unless it is the
    // last: B's slab s + 1 split from rb into the next slot, A's from ra
    // into (nh, nl) once slab s - 1 has retired, and (PRE) both operands'
    // slab s + 2 loaded into rb and ra; then the block's barrier
    template <bool LAST, bool PRE>
    __device__ __forceinline__ void slab(const float* A, const float* B,
                                         float* ring, int s,
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         uint32_t (&nh)[4], uint32_t (&nl)[4],
                                         float (&rb)[4], float (&ra)[4]) {
        const float* slot = ring + (s % RING) * 2 * SLAB;
        const uint64_t bhi = smem_desc(slot), blo = smem_desc(slot + SLAB);
        pin(accs);
        pin(acc);
        wgmma_fence();
        wgmma_tf32(accs, al, bhi);
        wgmma_tf32(acc, ah, bhi);
        wgmma_tf32(accs, ah, blo);
        wgmma_commit();
        pin(accs);
        pin(acc);
        if constexpr (LAST) {
            wgmma_wait<0>();
        } else {
            store_b(rb, ring + ((s + 1) % RING) * 2 * SLAB);
            if constexpr (PRE) load_b(B, 8 * (s + 2), rb);
            wgmma_wait<1>();
            split_a(ra, nh, nl);
            if constexpr (PRE) load_a(A, 8 * (s + 2), ra);
            fence_proxy_async();
            __syncthreads();
        }
        pin(accs);
        pin(acc);
    }

    // acc = A @ B (128 x 128, both swizzled) with `ring` (RING slots) as
    // the staging of B. Warp w reads rows 16 w .. 16 w + 15 of A and no
    // other, so it may overwrite them once run returns.
    __device__ __forceinline__ void run(const float* A, const float* B,
                                        float* ring) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
            acc[i] = 0.0f;
            accs[i] = 0.0f;
        }
        uint32_t h0[4], l0[4], h1[4], l1[4];
        float rb[4], ra[4];
        load_b(B, 0, rb);
        store_b(rb, ring);
        load_a(A, 0, ra);
        split_a(ra, h0, l0);
        load_b(B, 8, rb);
        load_a(A, 8, ra);
        fence_proxy_async();
        __syncthreads();
#pragma unroll 1
        for (int s = 0; s < NP / 8 - 2; s += 2) {
            slab<false, true>(A, B, ring, s, h0, l0, h1, l1, rb, ra);
            slab<false, true>(A, B, ring, s + 1, h1, l1, h0, l0, rb, ra);
        }
        slab<false, false>(A, B, ring, NP / 8 - 2, h0, l0, h1, l1, rb, ra);
        slab<true, false>(A, B, ring, NP / 8 - 1, h1, l1, h0, l0, rb, ra);
        // the small terms' sum first, then hi * hi (matmul_3xtf32's order)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = accs[i] + acc[i];
    }

    // f(row, column, value, value at column + 1) for every pair of entries
    // the thread holds: warp w's rows 16 w .. 16 w + 15, the m16n8
    // accumulator layout over 16 column blocks of 8 (a pair stays adjacent
    // under the swizzle, so f may store it as one float2)
    template <class F>
    __device__ __forceinline__ void for_each_pair(F f) const {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int i = 16 * warp + (lane >> 2), t = lane & 3;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int c = 8 * j + 2 * t;
            f(i, c, acc[4 * j], acc[4 * j + 1]);
            f(i + 8, c, acc[4 * j + 2], acc[4 * j + 3]);
        }
    }
};

// The same product in FP32 FMA on the SIMT cores, acc = A @ B[:, :COLS]
// (COLS = 128 on the CTA route, a 16-column panel on the cluster route):
// 16 x 16 threads, each with rows ty + 16 r and CC columns; A is read as
// float4 along k, and on the CTA route B too, as two float4 a row (columns
// 4 tx .. 4 tx + 3 and 64 + 4 tx .. 64 + 4 tx + 3), which cuts its loads
// fourfold; on a panel column tx. The sum runs over k in order (so both
// routes give the same bits).
template <int COLS>
struct SimtProduct {
    static constexpr int RR = NP / 16, CC = COLS / 16;
    static constexpr bool VEC = COLS == NP;
    static_assert(VEC || CC == 1, "a full width or one panel");
    float acc[RR][CC];

    __device__ __forceinline__ static int col(int tx, int c) {
        return VEC ? 4 * tx + (c & 3) + 64 * (c >> 2) : tx;
    }

    template <class BA>
    __device__ __forceinline__ void run(const float* A, const BA& b) {
        const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
        for (int r = 0; r < RR; ++r)
#pragma unroll
            for (int c = 0; c < CC; ++c) acc[r][c] = 0.0f;
#pragma unroll 2
        for (int k = 0; k < NP; k += 4) {
            float4 a[RR];
#pragma unroll
            for (int r = 0; r < RR; ++r)
                a[r] = *reinterpret_cast<const float4*>(
                    A + swz(ty + 16 * r, k));
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                float bv[CC];
                if constexpr (VEC) {
                    const float4 b0 = b.quad(k + kk, 4 * tx);
                    const float4 b1 = b.quad(k + kk, 64 + 4 * tx);
                    const float v[8] = {b0.x, b0.y, b0.z, b0.w,
                                        b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                    for (int c = 0; c < CC; ++c) bv[c] = v[c];
                } else {
                    bv[0] = b(k + kk, tx);
                }
#pragma unroll
                for (int r = 0; r < RR; ++r) {
                    const float av = kk == 0 ? a[r].x : kk == 1 ? a[r].y
                                   : kk == 2 ? a[r].z : a[r].w;
#pragma unroll
                    for (int c = 0; c < CC; ++c)
                        acc[r][c] = fmaf(av, bv[c], acc[r][c]);
                }
            }
        }
    }

    template <class F>
    __device__ __forceinline__ void for_each(F f) const {
        const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
        for (int r = 0; r < RR; ++r)
#pragma unroll
            for (int c = 0; c < CC; ++c)
                f(ty + 16 * r, col(tx, c), acc[r][c]);
    }
};

// (min of lo, max of hi) over the block's threads and, on the cluster
// route, over the cluster (through `cred`, a pair a block), NaN-propagating
// like jnp.min / jnp.max; every thread gets the result.
template <bool CL>
__device__ void minmax(float lo, float hi, float* red, float* cred,
                       int rank, float* out_lo, float* out_hi) {
    const int tid = threadIdx.x;
    for (int off = 16; off > 0; off >>= 1) {
        lo = schulz::nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = schulz::nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if ((tid & 31) == 0) {
        red[tid >> 5] = lo;
        red[NWARPS + (tid >> 5)] = hi;
    }
    __syncthreads();
    if (tid == 0) {
        float l = red[0], h = red[NWARPS];
        for (int w = 1; w < NWARPS; ++w) {
            l = schulz::nan_min(l, red[w]);
            h = schulz::nan_max(h, red[NWARPS + w]);
        }
        red[2 * NWARPS] = l;
        red[2 * NWARPS + 1] = h;
    }
    __syncthreads();
    lo = red[2 * NWARPS];
    hi = red[2 * NWARPS + 1];
    if constexpr (CL) {
        cg::cluster_group cluster = cg::this_cluster();
        float* mine = cred + 2 * rank;
        if (tid < CLUSTER) {
            float* dst = cluster.map_shared_rank(mine, tid);
            dst[0] = lo;
            dst[1] = hi;
        }
        cluster.sync();
        const float* all = cred;
        lo = all[0];
        hi = all[1];
        for (int r = 1; r < CLUSTER; ++r) {
            lo = schulz::nan_min(lo, all[2 * r]);
            hi = schulz::nan_max(hi, all[2 * r + 1]);
        }
    }
    *out_lo = lo;
    *out_hi = hi;
    __syncthreads();
}

// The matrix source of load_balanced for K3 and K5: a dense n x n
// row-major matrix in device memory. A source's build<BALANCE>(n, mb, sv)
// writes s = diag(M)^-1/2 (1 without BALANCE, and on the padding rows) to
// sv[0 .. NP) and M_b = S M S, padded with an identity block, to `mb`
// (swizzled), and ends in a barrier. K1 (csrc/kkt_schulz.cu) has its own
// source, which assembles M from the lazy factors as it balances.
struct DenseSource {
    const float* m;

    template <bool BALANCE>
    __device__ void build(int n, float* mb, float* sv) const {
        const int tid = threadIdx.x;
        for (int i = tid; i < NP; i += NTHREADS)
            sv[i] = (BALANCE && i < n) ? rsqrtf(m[i * n + i]) : 1.0f;
        __syncthreads();
        for (int idx = tid; idx < NP * NP; idx += NTHREADS) {
            const int i = idx / NP, j = idx % NP;
            float v = i == j ? 1.0f : 0.0f;
            if (i < n && j < n) {
                v = m[i * n + j];
                if constexpr (BALANCE) v *= sv[i] * sv[j];
            }
            mb[swz(i, j)] = v;
        }
        __syncthreads();
    }
};

// The common start of both routes, run by every block on the whole
// matrix: s and M_b from `src` (see DenseSource), the warm start
// X0_b = S^-1 X0 S^-1 padded with an identity block into `xs` (if x0), and
// c0 = 1 / (1.05 ||M_b||_inf) (the same bits in every block).
template <bool BALANCE, class Src>
__device__ float load_balanced(const Src& src, const float* __restrict__ x0,
                               int n, float* mb, float* xs, float* sv,
                               float* red) {
    const int tid = threadIdx.x;
    src.template build<BALANCE>(n, mb, sv);
    if (x0 != nullptr)
        for (int idx = tid; idx < NP * NP; idx += NTHREADS) {
            const int i = idx / NP, j = idx % NP;
            float v = i == j ? 1.0f : 0.0f;
            if (i < n && j < n) {
                v = x0[i * n + j];
                if constexpr (BALANCE) v /= sv[i] * sv[j];
            }
            xs[swz(i, j)] = v;
        }
    __syncthreads();
    float row = -INFINITY;
    if (tid < n) {
        row = 0.0f;
        for (int j = 0; j < NP; ++j) row += fabsf(mb[swz(tid, j)]);
    }
    float unused, norminf;
    minmax<false>(INFINITY, row, red, nullptr, 0, &unused, &norminf);
    return 1.0f / (1.05f * norminf);
}

// X <- ac (2I - ac M_b), the first step from c0 I folded (exact for any
// a): no product
__device__ __forceinline__ void fill_cold(float* xs, const float* mb,
                                          float ac) {
    for (int idx = threadIdx.x; idx < NP * NP; idx += NTHREADS) {
        const int i = idx / NP, j = idx % NP;
        xs[swz(i, j)] = ac * ((i == j ? 2.0f : 0.0f) - ac * mb[swz(i, j)]);
    }
}

// X <- c I
__device__ __forceinline__ void fill_eye(float* xs, float c) {
    for (int idx = threadIdx.x; idx < NP * NP; idx += NTHREADS) {
        const int i = idx / NP, j = idx % NP;
        xs[swz(i, j)] = i == j ? c : 0.0f;
    }
}

// One CTA-route step X <- X ((2a) I - a^2 M_b X) (TC: 3xTF32 wgmma, else
// FP32), T in `tm`, X updated in place after the product.
template <bool TC>
__device__ __forceinline__ void cta_step(const float* mb, float* xs,
                                         float* tm, float* ring, float aa) {
    const float two_a = 2.0f * aa, a2 = aa * aa;
    auto t_val = [&](int i, int j, float v) {
        return (i == j ? two_a : 0.0f) - a2 * v;
    };
    auto t_out = [&](int i, int j, float v) {
        tm[swz(i, j)] = t_val(i, j, v);
    };
    auto x_out = [&](int i, int j, float v) { xs[swz(i, j)] = v; };
    if constexpr (TC) {
        {
            WgProduct p;
            p.run(mb, xs, ring);
            p.for_each_pair([&](int i, int j, float v0, float v1) {
                *reinterpret_cast<float2*>(tm + swz(i, j)) =
                    make_float2(t_val(i, j, v0), t_val(i, j + 1, v1));
            });
        }
        __syncthreads();
        WgProduct p;
        p.run(xs, tm, ring);
        p.for_each_pair([&](int i, int j, float v0, float v1) {
            *reinterpret_cast<float2*>(xs + swz(i, j)) = make_float2(v0, v1);
        });
    } else {
        {
            SimtProduct<NP> p;
            p.run(mb, FullB{xs, 0});
            p.for_each(t_out);
        }
        __syncthreads();
        SimtProduct<NP> p;
        p.run(xs, FullB{tm, 0});
        __syncthreads();
        p.for_each(x_out);
    }
    __syncthreads();
}

// The basin-safeguarded (scaled) Newton-Schulz inverse of the n x n matrix
// `m` (row-major in device memory, n <= NP) by one block, written to
// `out`. With BALANCE the input is the unbalanced M: M_b = S M S with
// S = diag(M)^-1/2 and the result is S X S; without it (K5) the input is
// already balanced and the balanced X is written. The schedule's semantics
// are schulz_body.cuh's balanced_schulz: a warm start x0 (or null) takes
// the basin test on M_b X0_b (min diagonal > 1e-4 and max absolute row sum
// < 3) and then a plain step if it passed, the scaled cold step if not (an
// empty schedule returns X0_b or c0 I); without one the first step from
// c0 I is folded; scenarios that accepted their warm start run plain
// Newton (a = 1). Steps k < n_coeffs - hi_tail run 3xTF32.
//
// Shared memory: M_b, X and T (3 x 64 KB), the ring of B's hi / lo slabs
// (RING x 8 KB), s and the reduction scratch.
template <bool BALANCE, class Src>
__device__ void cta_schulz(float* smem, const Src& src,
                           const float* __restrict__ x0, int n,
                           const schulz::Schedule& sched, int n_coeffs,
                           int hi_tail, float* __restrict__ out) {
    float* mb = smem;
    float* xs = mb + NP * NP;
    float* tm = xs + NP * NP;
    float* ring = tm + NP * NP;
    float* sv = ring + RING * 2 * SLAB;
    float* red = sv + NP;
    const int tid = threadIdx.x;
    const bool warm = x0 != nullptr;
    const float c0 = load_balanced<BALANCE>(src, x0, n, mb, xs, sv, red);

    int start = 0;
    bool ok = false;
    if (warm) {
        {   // basin test on M_b X0_b (FP32), kept in T
            SimtProduct<NP> p;
            p.run(mb, FullB{xs, 0});
            p.for_each([&](int i, int j, float v) { tm[swz(i, j)] = v; });
        }
        __syncthreads();
        float d = INFINITY, rs = -INFINITY;
        if (tid < n) {
            d = tm[swz(tid, tid)];
            rs = 0.0f;
            for (int j = 0; j < NP; ++j) rs += fabsf(tm[swz(tid, j)]);
        }
        float dmin, rmax;
        minmax<false>(d, rs, red, nullptr, 0, &dmin, &rmax);
        ok = (dmin > 1e-4f) && (rmax < 3.0f);
        if (n_coeffs == 0) {
            // empty schedule: the accepted start as it is, else c0 I
            if (!ok) fill_eye(xs, c0);
        } else if (ok) {
            // T = 2I - M_b X0_b, then X0_b T in FP32
            for (int idx = tid; idx < NP * NP; idx += NTHREADS) {
                const int i = idx / NP, j = idx % NP;
                tm[swz(i, j)] = (i == j ? 2.0f : 0.0f) - tm[swz(i, j)];
            }
            __syncthreads();
            SimtProduct<NP> p;
            p.run(xs, FullB{tm, 0});
            __syncthreads();
            p.for_each([&](int i, int j, float v) { xs[swz(i, j)] = v; });
        } else {
            fill_cold(xs, mb, sched.a[0] * c0);   // the scaled cold step
        }
        start = 1;
    } else if (n_coeffs > 0) {
        fill_cold(xs, mb, sched.a[0] * c0);
        start = 1;
    } else {
        fill_eye(xs, c0);
    }
    __syncthreads();

    for (int k = start; k < n_coeffs; ++k) {
        const float aa = (warm && ok) ? 1.0f : sched.a[k];
        if (k < n_coeffs - hi_tail)
            cta_step<true>(mb, xs, tm, ring, aa);
        else
            cta_step<false>(mb, xs, tm, ring, aa);
    }

    for (int idx = tid; idx < NP * NP; idx += NTHREADS) {
        const int i = idx / NP, j = idx % NP;
        if (i < n && j < n) {
            float v = xs[swz(i, j)];
            if constexpr (BALANCE) v *= sv[i] * sv[j];
            out[i * n + j] = v;
        }
    }
}

// The cluster barrier in two halves: arrive (releasing this block's
// writes to its peers) and wait (acquiring theirs). Each thread alternates
// them.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Copy this block's columns col0 .. col0 + 15 of `arr` (NP x NP swizzled)
// into every peer's `arr` through distributed shared memory and arrive at
// the cluster barrier; the matching wait comes before `arr` is next read
// whole.
__device__ __forceinline__ void send_columns(float* arr, int col0, int rank) {
    __syncthreads();
    cg::cluster_group cluster = cg::this_cluster();
    for (int v = threadIdx.x; v < NP * PANEL / 4; v += NTHREADS) {
        const int at = swz(v >> 2, col0 + 4 * (v & 3));
        const float4 val = *reinterpret_cast<const float4*>(arr + at);
        for (int q = 1; q < CLUSTER; ++q)
            *reinterpret_cast<float4*>(
                cluster.map_shared_rank(arr, (rank + q) % CLUSTER) + at) = val;
    }
    cluster_arrive();
}

// One cluster-route step on this block's columns c: T_c = (2a) I_c -
// a^2 M_b X_c into the panel `tc` (this block's own data only), the wait
// for the peers' columns of X, then X'_c = X T_c into `nxt` here and in
// every peer (TC: 3xTF32 mma.sync, else FP32). The exchange of the last
// step overlaps T_c's product.
template <bool TC>
__device__ __forceinline__ void cluster_step(const float* mb,
                                             const float* cur, float* nxt,
                                             float* tc, float* stage,
                                             int col0, int rank, float aa) {
    const float two_a = 2.0f * aa, a2 = aa * aa;
    auto t_out = [&](int i, int j, float v) {
        tc[pswz(i, j)] = (i == col0 + j ? two_a : 0.0f) - a2 * v;
    };
    auto x_out = [&](int i, int j, float v) { nxt[swz(i, col0 + j)] = v; };
    if constexpr (TC) {
        {
            TcPanel p;
            p.run(mb, FullB{cur, col0}, stage);
            p.for_each(t_out);
        }
        __syncthreads();
        cluster_wait();
        TcPanel p;
        p.run(cur, PanelB{tc}, stage);
        p.for_each(x_out);
    } else {
        {
            SimtProduct<PANEL> p;
            p.run(mb, FullB{cur, col0});
            p.for_each(t_out);
        }
        __syncthreads();
        cluster_wait();
        SimtProduct<PANEL> p;
        p.run(cur, PanelB{tc});
        p.for_each(x_out);
    }
    send_columns(nxt, col0, rank);
}

// cta_schulz's function by block `rank` of a cluster of CLUSTER blocks.
// Every block holds all of M_b and of X (two buffers) and computes its 16
// columns c of each product: T_c = (2a) I_c - a^2 M_b X_c needs only its
// own columns of X, X'_c = X T_c all of X; so one exchange a step (the new
// columns of X into every peer's other buffer) and one cluster barrier,
// split: a block arrives after sending its columns and waits only before
// X T_c, so the exchange overlaps the next T_c. A block writes a peer's
// buffer only after every block has arrived from the step that read it
// (the wait before X T_c), so two buffers suffice. The basin test's row
// sums are summed over the blocks' partial sums (`part`), its
// diagonal minimum is a cluster reduction; the cold steps and the inf-norm
// need no exchange (every block has M_b).
//
// Shared memory: M_b and two X buffers (3 x 64 KB), the T panel and the B
// panel's hi / lo split (3 x 8 KB), s, the reduction scratch and slots,
// the partial row sums.
template <bool BALANCE, class Src>
__device__ void cluster_schulz(float* smem, int rank, const Src& src,
                               const float* __restrict__ x0, int n,
                               const schulz::Schedule& sched, int n_coeffs,
                               int hi_tail, float* __restrict__ out) {
    float* mb = smem;
    float* cur = mb + NP * NP;          // X
    float* nxt = cur + NP * NP;         // X's other buffer
    float* tc = nxt + NP * NP;          // T's panel
    float* stage = tc + NP * PANEL;     // the B panel, hi and lo
    float* sv = stage + 2 * NP * PANEL;
    float* red = sv + NP;
    float* cred = red + 2 * NWARPS + 2;
    float* part = cred + 2 * CLUSTER;   // partial row sums, a row per block
    const int tid = threadIdx.x;
    const int col0 = rank * PANEL;
    const bool warm = x0 != nullptr;
    cg::cluster_group cluster = cg::this_cluster();

    // a peer's shared memory exists before anyone writes to it
    cluster.sync();
    const float c0 = load_balanced<BALANCE>(src, x0, n, mb, cur, sv, red);

    int start = 0;
    bool ok = false;
    if (warm) {
        {   // basin test on M_b X0_b (FP32), this block's columns in T_c
            SimtProduct<PANEL> p;
            p.run(mb, FullB{cur, col0});
            p.for_each([&](int i, int j, float v) { tc[pswz(i, j)] = v; });
        }
        __syncthreads();
        if (tid < NP) {
            float ps = 0.0f;
            for (int j = 0; j < PANEL; ++j) ps += fabsf(tc[pswz(tid, j)]);
            for (int q = 0; q < CLUSTER; ++q)
                cluster.map_shared_rank(part, q)[rank * NP + tid] = ps;
        }
        cluster.sync();
        float d = INFINITY, rs = -INFINITY;
        if (tid < PANEL && col0 + tid < n) d = tc[pswz(col0 + tid, tid)];
        if (tid < n) {
            rs = 0.0f;
            for (int q = 0; q < CLUSTER; ++q) rs += part[q * NP + tid];
        }
        float dmin, rmax;
        minmax<true>(d, rs, red, cred, rank, &dmin, &rmax);
        ok = (dmin > 1e-4f) && (rmax < 3.0f);
        if (n_coeffs == 0) {
            if (!ok) fill_eye(cur, c0);
        } else if (ok) {
            // T_c = 2I_c - (M_b X0_b)_c, then (X0_b T)_c in FP32
            for (int idx = tid; idx < NP * PANEL; idx += NTHREADS) {
                const int i = idx / PANEL, j = idx % PANEL;
                tc[pswz(i, j)] =
                    (i == col0 + j ? 2.0f : 0.0f) - tc[pswz(i, j)];
            }
            __syncthreads();
            SimtProduct<PANEL> p;
            p.run(cur, PanelB{tc});
            p.for_each([&](int i, int j, float v) {
                nxt[swz(i, col0 + j)] = v;
            });
            send_columns(nxt, col0, rank);
            float* t = cur;
            cur = nxt;
            nxt = t;
        } else {
            fill_cold(cur, mb, sched.a[0] * c0);
        }
        start = 1;
    } else if (n_coeffs > 0) {
        fill_cold(cur, mb, sched.a[0] * c0);
        start = 1;
    } else {
        fill_eye(cur, c0);
    }
    __syncthreads();
    // every block filled all of X itself unless it sent columns above
    if (!(warm && ok && n_coeffs > 0)) cluster_arrive();

    for (int k = start; k < n_coeffs; ++k) {
        const float aa = (warm && ok) ? 1.0f : sched.a[k];
        if (k < n_coeffs - hi_tail)
            cluster_step<true>(mb, cur, nxt, tc, stage, col0, rank, aa);
        else
            cluster_step<false>(mb, cur, nxt, tc, stage, col0, rank, aa);
        float* t = cur;
        cur = nxt;
        nxt = t;
    }
    // the last columns have arrived; no peer writes here after this
    cluster_wait();

    for (int idx = tid; idx < NP * PANEL; idx += NTHREADS) {
        const int i = idx / PANEL, j = col0 + idx % PANEL;
        if (i < n && j < n) {
            float v = cur[swz(i, j)];
            if constexpr (BALANCE) v *= sv[i] * sv[j];
            out[i * n + j] = v;
        }
    }
}

// The inverse of one matrix, M from `src` (DenseSource or K1's), by one
// block (CL = false, rank 0) or by the block of rank `rank` of a cluster
// (CL = true).
template <bool CL, bool BALANCE, class Src>
__device__ void tc_schulz(float* smem, int rank, const Src& src,
                          const float* __restrict__ x0, int n,
                          const schulz::Schedule& sched, int n_coeffs,
                          int hi_tail, float* __restrict__ out) {
    if constexpr (CL)
        cluster_schulz<BALANCE>(smem, rank, src, x0, n, sched, n_coeffs,
                                hi_tail, out);
    else
        cta_schulz<BALANCE>(smem, src, x0, n, sched, n_coeffs, hi_tail,
                            out);
}

// Launch `kernel` on `matrices` clusters of `cluster` blocks (the kernels
// return at once unless cluster == CLUSTER). A launch the device refuses
// returns its error: there is no fallback route.
template <class Kernel, class... Args>
inline int launch_cluster(Kernel kernel, int matrices, int cluster,
                          cudaStream_t stream, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(matrices * CLUSTER, 1, 1);
    cfg.blockDim = dim3(NTHREADS, 1, 1);
    cfg.dynamicSmemBytes = Route<true>::SMEM_BYTES;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (e != cudaSuccess) {
        cudaGetLastError();   // a refused launch leaves no sticky error
        return (int)e;
    }
    return (int)cudaGetLastError();
}

// Allow `bytes` of dynamic shared memory for `kernel` (once per kernel).
template <class Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace schulz_tc
