// K2: the whole observe + EKF stage of a controller tick, one warp per
// scenario, for sm_90a.
//
// Replaces the TPU kernel go1_qp_mpc_controller_tpu/ops/pallas_ekf.py
// observe_ekf_lanes (_kernel, which inlines pallas_admm.schulz_lanes_body).
// The plain PyTorch version of the same function is
// ops/observe_ekf.py::observe_ekf_plain (the reference composition of
// controller.sensor_update: rotations + kinematics + ekf.update_estimation).
//
// What bounds it on an H100: operations. Per scenario it reads 1.5 KB (the
// 18x18 covariance dominates) and writes 1.8 KB, against ~1.0 MFLOP of
// FP32 work, almost all in the twelve-step 28x28 Newton-Schulz innovation
// inverse (the first step is folded, so 22 products of 2 x 28^3 FLOP). At
// batch 4096 that is 13.5 MB of traffic (4 us at 3.35 TB/s) and ~4.2 GFLOP
// (~63 us at 67 TFLOP/s of FP32 FMA), so the arithmetic sets the floor.
//
// What the design does about it: the TPU's batch-in-lanes layout does not
// carry over (one thread per scenario would need ~2.5K floats of live
// state), so each scenario gets one warp, four to a 128-thread block, and
// its matrices (P, P-bar, S, the Schulz iterate, P-bar C' then the gain)
// live in 12 KB of static shared memory per warp: four blocks, 16
// scenarios, fit on an SM. Every phase syncs with __syncwarp only. Every
// product is laid out with lane j owning column j of its result: the
// right operand's column sits in lane j's registers and the left operand's
// rows are broadcast shared reads, four along k at a time (float4), so a
// lane runs up to 28 independent accumulators, its loads fall to a quarter
// of its FMAs and a step writes only the new columns of X back to shared
// memory. The Schulz step T[:, j] = 2a e_j - a^2 S X[:, j], X'[:, j] =
// X T[:, j] keeps T in registers. P-bar = A P A' + Q, P-bar C', S = C P-bar
// C' + R (C through its +e / -e structure, never multiplied), the gain
// K = P-bar C' S^-1 and the Joseph update (I - K C) P-bar (I - K C)' +
// K R K' follow the same layout. Global memory is touched once per input
// and once per output, a warp reading its scenario's contiguous rows. All
// FP32 FMA, like the TPU kernel. CUDA has atan2f and asinf, so euler and
// rot_z are folded in (the TPU kernel computed them outside because Mosaic
// lacks them).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NS = 18;            // EKF state
constexpr int NM = 28;            // measurements
constexpr int LD = 20;            // row stride of the 18 x 18 matrices
constexpr int WARPS = 4;          // scenarios per block
constexpr int NT = 32 * WARPS;
constexpr int MAX_COEFFS = 32;

constexpr float PROCESS_NOISE_PIMU = 0.01f;
constexpr float PROCESS_NOISE_VIMU = 0.01f;
constexpr float PROCESS_NOISE_PFOOT = 0.01f;
constexpr float SENSOR_NOISE_PIMU_REL_FOOT = 0.001f;
constexpr float SENSOR_NOISE_VIMU_REL_FOOT = 0.1f;
constexpr float SENSOR_NOISE_ZFOOT = 0.001f;
constexpr float EKF_GRAVITY = 9.81f;

struct Schedule {
    float a[MAX_COEFFS];
};

// One scenario's shared memory (11,984 bytes; rows 16-byte aligned).
struct alignas(16) WarpSmem {
    float p[NS * LD];       // P, then (I - K C) P-bar
    float pbar[NS * LD];    // P-bar, then the Joseph sum
    float s[NM * NM];       // C P-bar C' + R, then S_b, then I - K C
    float x[NM * NM];       // the Schulz iterate
    float pct[NS * NM];     // P-bar C', then the gain K
    float rot[12], u[4], gyro[4], fpr[12], fvr[12], estc[4], infl[4];
    float xs[20], xbar[20], y[NM], err[NM], r[NM], bal[NM];
};

// Row r of the measurement matrix C is +1 at column c_pos(r) and -1 at
// column c_neg(r) (none when negative) (A1BasicEKF.cpp:11-17).
__host__ __device__ constexpr int c_pos(int r) {
    return r < 12 ? 6 + r : (r < 24 ? 3 + (r - 12) % 3 : 8 + 3 * (r - 24));
}

__host__ __device__ constexpr int c_neg(int r) { return r < 12 ? r % 3 : -1; }

__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || a > b) ? a : b;
}

// out[i] = sum_k A[i * lda + k] v[k] (k ascending) for i < ROWS: A's rows
// are broadcast shared reads, four along k at a time, v sits in registers.
// k runs outside i, so the ROWS sums advance together (ROWS independent
// FMA chains in flight).
template <int ROWS, int K>
__device__ __forceinline__ void rows_times(const float* A, int lda,
                                           const float (&v)[K],
                                           float (&out)[ROWS]) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) out[i] = 0.0f;
#pragma unroll
    for (int k = 0; k + 4 <= K; k += 4) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
            const float4 q = *reinterpret_cast<const float4*>(A + i * lda + k);
            out[i] = fmaf(q.x, v[k], out[i]);
            out[i] = fmaf(q.y, v[k + 1], out[i]);
            out[i] = fmaf(q.z, v[k + 2], out[i]);
            out[i] = fmaf(q.w, v[k + 3], out[i]);
        }
    }
    if constexpr (K % 4 == 2) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
            const float2 q =
                *reinterpret_cast<const float2*>(A + i * lda + K - 2);
            out[i] = fmaf(q.x, v[K - 2], out[i]);
            out[i] = fmaf(q.y, v[K - 1], out[i]);
        }
    }
}

__global__ void __launch_bounds__(NT, 4)
observe_ekf_kernel(const float* __restrict__ x_in,     // (B, 18)
                   const float* __restrict__ p_in,     // (B, 18, 18)
                   const float* __restrict__ quat,     // (B, 4)
                   const float* __restrict__ acc,      // (B, 3)
                   const float* __restrict__ gyro,     // (B, 3)
                   const float* __restrict__ qpos,     // (B, 12)
                   const float* __restrict__ qvel,     // (B, 12)
                   const float* __restrict__ ffoot,    // (B, 4)
                   const int* __restrict__ mode,       // (B,)
                   const float* __restrict__ rho_opt,  // (4, 3)
                   const float* __restrict__ rho_fix,  // (4, 5)
                   float dt, float cfn, int flat, Schedule sched,
                   int n_coeffs, int batch,
                   float* __restrict__ rot_out,        // (B, 3, 3)
                   float* __restrict__ euler_out,      // (B, 3)
                   float* __restrict__ rotz_out,       // (B, 3, 3)
                   float* __restrict__ fpr_out,        // (B, 4, 3)
                   float* __restrict__ fpa_out,        // (B, 4, 3)
                   float* __restrict__ fvr_out,        // (B, 4, 3)
                   float* __restrict__ jf_out,         // (B, 4, 3, 3)
                   float* __restrict__ wav_out,        // (B, 3)
                   float* __restrict__ x_out,          // (B, 18)
                   float* __restrict__ p_out,          // (B, 18, 18)
                   float* __restrict__ estc_out) {     // (B, 4)
    __shared__ WarpSmem smem[WARPS];
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= batch) return;              // the whole warp
    WarpSmem& sm = smem[threadIdx.x >> 5];

    // ---- 1. loads; observe: legs (lanes 0-3), body (4), euler (5) ------
    if (lane < NS) sm.xs[lane] = x_in[b * NS + lane];
    for (int idx = lane; idx < NS * NS; idx += 32) {
        const int i = idx / NS;
        sm.p[i * LD + idx - NS * i] = p_in[(size_t)b * NS * NS + idx];
    }
    if (lane < 4) {
        const int l = lane;
        const float q1 = qpos[b * 12 + 3 * l], q2 = qpos[b * 12 + 3 * l + 1],
                    q3 = qpos[b * 12 + 3 * l + 2];
        const float cx = rho_opt[3 * l], cy = rho_opt[3 * l + 1],
                    cz = rho_opt[3 * l + 2];
        const float ox = rho_fix[5 * l], oy = rho_fix[5 * l + 1],
                    d = rho_fix[5 * l + 2], lt = rho_fix[5 * l + 3],
                    lc = rho_fix[5 * l + 4];
        const float s1 = sinf(q1), c1 = cosf(q1);
        const float s2 = sinf(q2), c2 = cosf(q2);
        const float s23 = sinf(q2 + q3), c23 = cosf(q2 + q3);
        const float calf = lc - cz, hip = cy + d;
        const float x_plane = cx * c23 - calf * s23 - lt * s2;
        const float a = lt * c2 + calf * c23 + cx * s23;
        const float p[3] = {ox + x_plane, oy + hip * c1 + a * s1,
                            hip * s1 - a * c1};
        const float da2 = -lt * s2 - calf * s23 + cx * c23;
        const float da3 = -calf * s23 + cx * c23;
        const float bb = calf * c23 + cx * s23;
        // J[i][j] = d p_i / d q_j (models/kinematics.py jac)
        const float J[3][3] = {{0.0f, -a, -bb},
                               {-hip * s1 + a * c1, s1 * da2, s1 * da3},
                               {hip * c1 + a * s1, -c1 * da2, -c1 * da3}};
        const float dq[3] = {qvel[b * 12 + 3 * l], qvel[b * 12 + 3 * l + 1],
                             qvel[b * 12 + 3 * l + 2]};
        for (int i = 0; i < 3; ++i) {
            const float v = J[i][0] * dq[0] + J[i][1] * dq[1]
                          + J[i][2] * dq[2];
            sm.fpr[3 * l + i] = p[i];
            sm.fvr[3 * l + i] = v;
            fpr_out[b * 12 + 3 * l + i] = p[i];
            fvr_out[b * 12 + 3 * l + i] = v;
            for (int j = 0; j < 3; ++j)
                jf_out[b * 36 + 9 * l + 3 * i + j] = J[i][j];
        }
        // contact weights (A1BasicEKF.cpp:79-86)
        const float cw = fminf(fmaxf(ffoot[b * 4 + l] / cfn, 0.0f), 1.0f);
        const float c = mode[b] == 0 ? 1.0f : cw;
        sm.estc[l] = c;
        sm.infl[l] = 1.0f + (1.0f - c) * 1e3f;
        estc_out[b * 4 + l] = c;
    } else if (lane == 4) {
        const float w = quat[b * 4], qx = quat[b * 4 + 1],
                    qy = quat[b * 4 + 2], qz = quat[b * 4 + 3];
        const float nrm = sqrtf(w * w + qx * qx + qy * qy + qz * qz);
        const float nw = w / nrm, nx = qx / nrm, ny = qy / nrm,
                    nz = qz / nrm;
        const float r[9] = {
            1 - 2 * (ny * ny + nz * nz), 2 * (nx * ny - nw * nz),
            2 * (nx * nz + nw * ny),
            2 * (nx * ny + nw * nz), 1 - 2 * (nx * nx + nz * nz),
            2 * (ny * nz - nw * nx),
            2 * (nx * nz - nw * ny), 2 * (ny * nz + nw * nx),
            1 - 2 * (nx * nx + ny * ny)};
        const float g[3] = {gyro[b * 3], gyro[b * 3 + 1], gyro[b * 3 + 2]};
        const float ac[3] = {acc[b * 3], acc[b * 3 + 1], acc[b * 3 + 2]};
        for (int i = 0; i < 9; ++i) {
            sm.rot[i] = r[i];
            rot_out[b * 9 + i] = r[i];
        }
        for (int i = 0; i < 3; ++i) {
            sm.gyro[i] = g[i];
            wav_out[b * 3 + i] = r[3 * i] * g[0] + r[3 * i + 1] * g[1]
                               + r[3 * i + 2] * g[2];
            sm.u[i] = r[3 * i] * ac[0] + r[3 * i + 1] * ac[1]
                    + r[3 * i + 2] * ac[2];
        }
        sm.u[2] -= EKF_GRAVITY;
    } else if (lane == 5) {
        // euler from the raw quaternion (utils/rotations.py quat_to_euler)
        const float w = quat[b * 4], qx = quat[b * 4 + 1],
                    qy = quat[b * 4 + 2], qz = quat[b * 4 + 3];
        const float y_sqr = qy * qy;
        const float roll = atan2f(2.0f * (w * qx + qy * qz),
                                  1.0f - 2.0f * (qx * qx + y_sqr));
        const float pitch = asinf(
            fminf(fmaxf(2.0f * (w * qy - qz * qx), -1.0f), 1.0f));
        const float yaw = atan2f(2.0f * (w * qz + qx * qy),
                                 1.0f - 2.0f * (y_sqr + qz * qz));
        const float cyaw = cosf(yaw), syaw = sinf(yaw);
        const float rz[9] = {cyaw, -syaw, 0.0f, syaw, cyaw, 0.0f,
                             0.0f, 0.0f, 1.0f};
        for (int i = 0; i < 9; ++i) rotz_out[b * 9 + i] = rz[i];
        euler_out[b * 3] = roll;
        euler_out[b * 3 + 1] = pitch;
        euler_out[b * 3 + 2] = yaw;
    }
    __syncwarp();

    // ---- 2. measurements (lanes 0-3), predict, noise, P-bar ------------
    if (lane < 4) {
        const int l = lane;
        const float* f = sm.fpr + 3 * l;
        const float* v = sm.fvr + 3 * l;
        const float* g = sm.gyro;
        // leg odometry: -v_foot - omega x p_foot, rotated to the world
        const float lv[3] = {-v[0] - (g[1] * f[2] - g[2] * f[1]),
                             -v[1] - (g[2] * f[0] - g[0] * f[2]),
                             -v[2] - (g[0] * f[1] - g[1] * f[0])};
        const float c = sm.estc[l];
        for (int i = 0; i < 3; ++i) {
            const float fa = sm.rot[3 * i] * f[0] + sm.rot[3 * i + 1] * f[1]
                           + sm.rot[3 * i + 2] * f[2];
            const float lw = sm.rot[3 * i] * lv[0]
                           + sm.rot[3 * i + 1] * lv[1]
                           + sm.rot[3 * i + 2] * lv[2];
            fpa_out[b * 12 + 3 * l + i] = fa;
            sm.y[3 * l + i] = fa;
            sm.y[12 + 3 * l + i] = (1.0f - c) * sm.xs[3 + i] + c * lw;
        }
        sm.y[24 + l] = (1.0f - c) * (sm.xs[2] + f[2]);
    }
    if (lane < NS) {
        const int i = lane;
        sm.xbar[i] = i < 3 ? sm.xs[i] + dt * sm.xs[i + 3]
                   : (i < 6 ? sm.xs[i] + dt * sm.u[i - 3] : sm.xs[i]);
    }
    if (lane < NM) {
        const int r = lane;
        const float infl = sm.infl[r < 24 ? (r % 12) / 3 : r - 24];
        sm.r[r] = r < 12 ? infl * SENSOR_NOISE_PIMU_REL_FOOT
                : (r < 24 ? infl * SENSOR_NOISE_VIMU_REL_FOOT
                          : (flat ? infl * SENSOR_NOISE_ZFOOT : 1e5f));
    }
    // P-bar = A P A' + Q with A = I + dt E(0:3 <- 3:6): lane j, column j
    if (lane < NS) {
        const int j = lane;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            float ap = sm.p[i * LD + j];
            if (i < 3) ap += dt * sm.p[(i + 3) * LD + j];
            if (j < 3) {
                float ap3 = sm.p[i * LD + j + 3];
                if (i < 3) ap3 += dt * sm.p[(i + 3) * LD + j + 3];
                ap += dt * ap3;
            }
            if (i == j)
                ap += i < 3 ? PROCESS_NOISE_PIMU * dt / 20.0f
                    : (i < 6 ? PROCESS_NOISE_VIMU * dt * 9.8f / 20.0f
                             : sm.infl[(i - 6) / 3] * dt
                                   * PROCESS_NOISE_PFOOT);
            sm.pbar[i * LD + j] = ap;
        }
    }
    __syncwarp();

    // ---- 3. residual, P-bar C', S = C P-bar C' + R (lane c, column c) ---
    const int c = lane < NM ? lane : NM - 1;   // lanes 28-31 compute nothing
    const bool col = lane < NM;
    float sc[NM] = {};                         // S's column c
    if (col) {
        sm.err[c] = sm.y[c] - (sm.xbar[c_pos(c)]
                               - (c_neg(c) >= 0 ? sm.xbar[c_neg(c)] : 0.0f));
        const int pc = c_pos(c), nc = c_neg(c);
        float pct[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            pct[i] = sm.pbar[i * LD + pc]
                   - (nc >= 0 ? sm.pbar[i * LD + nc] : 0.0f);
            sm.pct[i * NM + c] = pct[i];
        }
        const float rc = sm.r[c];
#pragma unroll
        for (int r = 0; r < NM; ++r) {
            const int nr = c_neg(r);
            float v = pct[c_pos(r)];
            if (nr >= 0) v -= pct[nr];
            if (r == c) v += rc;
            sc[r] = v;
            sm.s[r * NM + c] = v;
        }
    }
    __syncwarp();
    // symmetrize, then the Jacobi balance S_b = S s_r s_c
    float dc = 1.0f;
    if (col) {
#pragma unroll
        for (int r = 0; r < NM; ++r) {
            sc[r] = 0.5f * (sc[r] + sm.s[c * NM + r]);
            if (r == c) dc = sc[r];
        }
    }
    __syncwarp();
    if (col) sm.bal[c] = rsqrtf(dc);
    __syncwarp();
    float row = -INFINITY;
    if (col) {
        const float bc = sm.bal[c];
        row = 0.0f;
#pragma unroll
        for (int r = 0; r < NM; ++r) {
            sc[r] *= sm.bal[r] * bc;
            sm.s[r * NM + c] = sc[r];
            // S_b is symmetric to the bit, so its column sum is the row sum
            row += fabsf(sc[r]);
        }
    }
    for (int off = 16; off > 0; off >>= 1)
        row = nan_max(row, __shfl_xor_sync(0xffffffffu, row, off));

    // ---- 4. scaled Newton-Schulz S_b^-1: X's column c in registers ------
    const float ac0 = sched.a[0] / (1.05f * row);
    float xc[NM];
#pragma unroll
    for (int r = 0; r < NM; ++r)
        xc[r] = ac0 * ((r == c ? 2.0f : 0.0f) - ac0 * sc[r]);
    for (int k = 1; k < n_coeffs; ++k) {
        const float a = sched.a[k];
        if (col) {
#pragma unroll
            for (int r = 0; r < NM; ++r) sm.x[r * NM + c] = xc[r];
        }
        __syncwarp();
        if (col) {
            float t[NM];
            rows_times<NM, NM>(sm.s, NM, xc, t);       // S_b X[:, c]
#pragma unroll
            for (int r = 0; r < NM; ++r)
                t[r] = (r == c ? 2.0f * a : 0.0f) - (a * a) * t[r];
            rows_times<NM, NM>(sm.x, NM, t, xc);       // X T[:, c]
        }
        __syncwarp();
    }
    // unbalance: S^-1[:, c] = X[:, c] s_r s_c
    if (col) {
        const float bc = sm.bal[c];
#pragma unroll
        for (int r = 0; r < NM; ++r) xc[r] *= sm.bal[r] * bc;
    }

    // ---- 5. gain K = P-bar C' S^-1 (in place of P-bar C'), state -------
    float kc[NS];
    if (col) rows_times<NS, NM>(sm.pct, NM, xc, kc);
    __syncwarp();
    if (col) {
#pragma unroll
        for (int i = 0; i < NS; ++i) sm.pct[i * NM + c] = kc[i];
    }
    __syncwarp();
    const float* kg = sm.pct;
    if (lane < NS) {
        float acc_v = 0.0f;
        for (int m = 0; m < NM; ++m)
            acc_v = fmaf(kg[lane * NM + m], sm.err[m], acc_v);
        x_out[b * NS + lane] = sm.xbar[lane] + acc_v;
    }
    // I - K C through C's structure, lane j column j, into the S slot
    float* ikc = sm.s;
    if (lane < NS) {
        const int j = lane;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            const float* k = kg + i * NM;
            float kcv;
            if (j < 3) {
                kcv = -(k[j] + k[3 + j] + k[6 + j] + k[9 + j]);
            } else if (j < 6) {
                kcv = k[9 + j] + k[12 + j] + k[15 + j] + k[18 + j];
            } else {
                const int l = (j - 6) / 3, cc = (j - 6) % 3;
                kcv = k[3 * l + cc] + (cc == 2 ? k[24 + l] : 0.0f);
            }
            ikc[i * LD + j] = (i == j ? 1.0f : 0.0f) - kcv;
        }
    }
    __syncwarp();

    // ---- 6. Joseph covariance, lane j column j -------------------------
    // (I - K C) P-bar into the P slot
    if (lane < NS) {
        float pj[NS], q[NS];
#pragma unroll
        for (int m = 0; m < NS; ++m) pj[m] = sm.pbar[m * LD + lane];
        rows_times<NS, NS>(ikc, LD, pj, q);
#pragma unroll
        for (int i = 0; i < NS; ++i) sm.p[i * LD + lane] = q[i];
    }
    __syncwarp();
    // P_new = ((I - K C) P-bar) (I - K C)' + K R K' into the P-bar slot
    float pn[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) pn[i] = 0.0f;
    if (lane < NS) {
        const int j = lane;
        float mj[NS], rk[NM], kr[NS];
#pragma unroll
        for (int m = 0; m < NS; ++m) mj[m] = ikc[j * LD + m];
#pragma unroll
        for (int m = 0; m < NM; ++m) rk[m] = sm.r[m] * kg[j * NM + m];
        rows_times<NS, NS>(sm.p, LD, mj, pn);
        rows_times<NS, NM>(kg, NM, rk, kr);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            pn[i] += kr[i];
            sm.pbar[i * LD + j] = pn[i];
        }
    }
    __syncwarp();
    if (lane < NS) {
#pragma unroll
        for (int i = 0; i < NS; ++i)
            pn[i] = 0.5f * (pn[i] + sm.pbar[lane * LD + i]);
    }

    // ---- 7. xy covariance surgery (A1BasicEKF.cpp:143-147), store -------
    const float p00 = __shfl_sync(0xffffffffu, pn[0], 0);
    const float p10 = __shfl_sync(0xffffffffu, pn[1], 0);
    const float p01 = __shfl_sync(0xffffffffu, pn[0], 1);
    const float p11 = __shfl_sync(0xffffffffu, pn[1], 1);
    const bool shrink = p00 * p11 - p01 * p10 > 1e-6f;
    if (lane < NS) {
        const int j = lane;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            float v = pn[i];
            if (shrink) {
                if ((i < 2) != (j < 2)) v = 0.0f;
                else if (i < 2) v *= 0.1f;
            }
            p_out[(size_t)b * NS * NS + i * NS + j] = v;
        }
    }
}

}  // namespace

extern "C" int observe_ekf_launch(
    const float* x, const float* P, const float* quat, const float* acc,
    const float* gyro, const float* qpos, const float* qvel,
    const float* ffoot, const int* mode, const float* rho_opt,
    const float* rho_fix, float dt, float cfn, int flat,
    const float* coeffs, int n_coeffs, float* rot, float* euler,
    float* rot_z, float* fpr, float* fpa, float* fvr, float* jf, float* wav,
    float* x_out, float* p_out, float* estc, int batch,
    cudaStream_t stream) {
    if (n_coeffs < 1 || n_coeffs > MAX_COEFFS)
        return (int)cudaErrorInvalidValue;
    Schedule sched;
    for (int k = 0; k < MAX_COEFFS; ++k)
        sched.a[k] = k < n_coeffs ? coeffs[k] : 1.0f;
    observe_ekf_kernel<<<(batch + WARPS - 1) / WARPS, NT, 0, stream>>>(
        x, P, quat, acc, gyro, qpos, qvel, ffoot, mode, rho_opt, rho_fix,
        dt, cfn, flat, sched, n_coeffs, batch, rot, euler, rot_z, fpr, fpa,
        fvr, jf, wav, x_out, p_out, estc);
    return (int)cudaGetLastError();
}
