// K2: the whole observe + EKF stage of a controller tick, one thread
// block per scenario, for sm_90a.
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
// (~63 us at 67 TFLOP/s of FP32 FMA), so the arithmetic, not the traffic,
// sets the floor; in practice the latency of the dependent chain of small
// products does.
//
// What the design does about it: the TPU's batch-in-lanes layout does not
// carry over (one thread per scenario would need ~2.5K floats of live
// state, far over 255 registers), so each scenario gets one block of 128
// threads and keeps every matrix (P, P-bar, S, the Schulz iterate and its
// scratch, the gain) in 21 KB of static shared memory: ~10 blocks fit on
// an SM, which hides the latency of the dependent products. Global memory
// is touched once per input and once per output, each block reading its
// scenario's contiguous rows (coalesced). The measurement matrix C is
// applied through its structure (each row is +e_p - e_n), never
// multiplied. Everything is FP32 FMA, like the TPU kernel. CUDA has atan2f
// and asinf, so euler and rot_z are folded in (the TPU kernel computed them
// outside because Mosaic lacks them).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NS = 18;            // EKF state
constexpr int NM = 28;            // measurements
constexpr int NT = 128;           // threads per block (one scenario)
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

// Row r of the measurement matrix C is +1 at column c_pos(r) and -1 at
// column c_neg(r) (none when negative) (A1BasicEKF.cpp:11-17).
__device__ __forceinline__ int c_pos(int r) {
    return r < 12 ? 6 + r : (r < 24 ? 3 + (r - 12) % 3 : 8 + 3 * (r - 24));
}

__device__ __forceinline__ int c_neg(int r) { return r < 12 ? r % 3 : -1; }

__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || a > b) ? a : b;
}

__global__ void __launch_bounds__(NT)
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
                   int n_coeffs,
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
    __shared__ float s_rot[9], s_u[3], s_gyro[3];
    __shared__ float s_fpr[12], s_fvr[12], s_estc[4], s_infl[4];
    __shared__ float s_x[NS], s_xbar[NS], s_y[NM], s_err[NM], s_r[NM];
    __shared__ float s_bal[NM], s_red[1];
    __shared__ float s_p[NS * NS], s_pbar[NS * NS], s_m18[NS * NS];
    __shared__ float s_s[NM * NM], s_t[NM * NM], s_xa[NM * NM],
        s_xb[NM * NM];
    __shared__ float s_pct[NS * NM], s_k[NS * NM];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;

    // ---- 1. observe: legs (threads 0-3), body (thread 4), loads -------
    if (tid < 4) {
        const int l = tid;
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
            s_fpr[3 * l + i] = p[i];
            s_fvr[3 * l + i] = v;
            fpr_out[b * 12 + 3 * l + i] = p[i];
            fvr_out[b * 12 + 3 * l + i] = v;
            for (int j = 0; j < 3; ++j)
                jf_out[b * 36 + 9 * l + 3 * i + j] = J[i][j];
        }
        // contact weights (A1BasicEKF.cpp:79-86)
        const float cw = fminf(fmaxf(ffoot[b * 4 + l] / cfn, 0.0f), 1.0f);
        const float c = mode[b] == 0 ? 1.0f : cw;
        s_estc[l] = c;
        s_infl[l] = 1.0f + (1.0f - c) * 1e3f;
        estc_out[b * 4 + l] = c;
    } else if (tid == 4) {
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
        // euler from the raw quaternion (utils/rotations.py quat_to_euler)
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
        const float g[3] = {gyro[b * 3], gyro[b * 3 + 1], gyro[b * 3 + 2]};
        const float ac[3] = {acc[b * 3], acc[b * 3 + 1], acc[b * 3 + 2]};
        for (int i = 0; i < 9; ++i) {
            s_rot[i] = r[i];
            rot_out[b * 9 + i] = r[i];
            rotz_out[b * 9 + i] = rz[i];
        }
        euler_out[b * 3] = roll;
        euler_out[b * 3 + 1] = pitch;
        euler_out[b * 3 + 2] = yaw;
        for (int i = 0; i < 3; ++i) {
            s_gyro[i] = g[i];
            wav_out[b * 3 + i] = r[3 * i] * g[0] + r[3 * i + 1] * g[1]
                               + r[3 * i + 2] * g[2];
            s_u[i] = r[3 * i] * ac[0] + r[3 * i + 1] * ac[1]
                   + r[3 * i + 2] * ac[2];
        }
        s_u[2] -= EKF_GRAVITY;
    } else if (tid >= 32 && tid < 32 + NS) {
        s_x[tid - 32] = x_in[b * NS + tid - 32];
    }
    for (int idx = tid; idx < NS * NS; idx += NT)
        s_p[idx] = p_in[(size_t)b * NS * NS + idx];
    __syncthreads();

    // ---- 2. measurements, predict ---------------------------------------
    if (tid < 4) {
        const int l = tid;
        const float* f = s_fpr + 3 * l;
        const float* v = s_fvr + 3 * l;
        const float* g = s_gyro;
        // leg odometry: -v_foot - omega x p_foot, rotated to the world
        const float lv[3] = {-v[0] - (g[1] * f[2] - g[2] * f[1]),
                             -v[1] - (g[2] * f[0] - g[0] * f[2]),
                             -v[2] - (g[0] * f[1] - g[1] * f[0])};
        const float c = s_estc[l];
        for (int i = 0; i < 3; ++i) {
            const float fa = s_rot[3 * i] * f[0] + s_rot[3 * i + 1] * f[1]
                           + s_rot[3 * i + 2] * f[2];
            const float lw = s_rot[3 * i] * lv[0] + s_rot[3 * i + 1] * lv[1]
                           + s_rot[3 * i + 2] * lv[2];
            fpa_out[b * 12 + 3 * l + i] = fa;
            s_y[3 * l + i] = fa;
            s_y[12 + 3 * l + i] = (1.0f - c) * s_x[3 + i] + c * lw;
        }
        s_y[24 + l] = (1.0f - c) * (s_x[2] + f[2]);
    } else if (tid >= 32 && tid < 32 + NS) {
        const int i = tid - 32;
        s_xbar[i] = i < 3 ? s_x[i] + dt * s_x[i + 3]
                  : (i < 6 ? s_x[i] + dt * s_u[i - 3] : s_x[i]);
    } else if (tid >= 64 && tid < 64 + NM) {
        const int r = tid - 64;
        const float infl = s_infl[r < 24 ? (r % 12) / 3 : r - 24];
        s_r[r] = r < 12 ? infl * SENSOR_NOISE_PIMU_REL_FOOT
               : (r < 24 ? infl * SENSOR_NOISE_VIMU_REL_FOOT
                         : (flat ? infl * SENSOR_NOISE_ZFOOT : 1e5f));
    }
    // P-bar = A P A' + Q with A = I + dt E(0:3 <- 3:6)
    for (int idx = tid; idx < NS * NS; idx += NT) {
        const int i = idx / NS, j = idx % NS;
        float ap = s_p[i * NS + j];
        if (i < 3) ap += dt * s_p[(i + 3) * NS + j];
        if (j < 3) {
            float ap3 = s_p[i * NS + j + 3];
            if (i < 3) ap3 += dt * s_p[(i + 3) * NS + j + 3];
            ap += dt * ap3;
        }
        if (i == j)
            ap += i < 3 ? PROCESS_NOISE_PIMU * dt / 20.0f
                : (i < 6 ? PROCESS_NOISE_VIMU * dt * 9.8f / 20.0f
                         : s_infl[(i - 6) / 3] * dt * PROCESS_NOISE_PFOOT);
        s_pbar[idx] = ap;
    }
    __syncthreads();

    // ---- 3. innovation S = C P-bar C' + R, and P-bar C' -----------------
    if (tid < NM) {
        const int pr = c_pos(tid), nr = c_neg(tid);
        s_err[tid] = s_y[tid] - (s_xbar[pr] - (nr >= 0 ? s_xbar[nr] : 0.0f));
    }
    for (int idx = tid; idx < NM * NM; idx += NT) {
        const int r = idx / NM, c = idx % NM;
        const int pr = c_pos(r), nr = c_neg(r), pc = c_pos(c), nc = c_neg(c);
        float v = s_pbar[pr * NS + pc];
        if (nr >= 0) v -= s_pbar[nr * NS + pc];
        if (nc >= 0) {
            float w = s_pbar[pr * NS + nc];
            if (nr >= 0) w -= s_pbar[nr * NS + nc];
            v -= w;
        }
        if (r == c) v += s_r[r];
        s_t[idx] = v;
    }
    for (int idx = tid; idx < NS * NM; idx += NT) {
        const int i = idx / NM, r = idx % NM;
        const int pr = c_pos(r), nr = c_neg(r);
        s_pct[idx] = s_pbar[i * NS + pr] - (nr >= 0 ? s_pbar[i * NS + nr]
                                                    : 0.0f);
    }
    __syncthreads();
    for (int idx = tid; idx < NM * NM; idx += NT) {
        const int r = idx / NM, c = idx % NM;
        s_s[idx] = 0.5f * (s_t[idx] + s_t[c * NM + r]);
    }
    __syncthreads();

    // ---- 4. scaled Newton-Schulz S^-1 on the Jacobi-balanced S ----------
    if (tid < NM) s_bal[tid] = rsqrtf(s_s[tid * NM + tid]);
    __syncthreads();
    for (int idx = tid; idx < NM * NM; idx += NT) {
        const int r = idx / NM, c = idx % NM;
        s_s[idx] *= s_bal[r] * s_bal[c];
    }
    __syncthreads();
    if (tid < 32) {
        float row = -INFINITY;
        if (tid < NM) {
            row = 0.0f;
            for (int c = 0; c < NM; ++c) row += fabsf(s_s[tid * NM + c]);
        }
        for (int off = 16; off > 0; off >>= 1)
            row = nan_max(row, __shfl_xor_sync(0xffffffffu, row, off));
        if (tid == 0) s_red[0] = row;
    }
    __syncthreads();
    const float ac0 = sched.a[0] / (1.05f * s_red[0]);
    // first step folded from the scalar cold init c I
    for (int idx = tid; idx < NM * NM; idx += NT) {
        const int r = idx / NM, c = idx % NM;
        s_xa[idx] = ac0 * ((r == c ? 2.0f : 0.0f) - ac0 * s_s[idx]);
    }
    __syncthreads();
    float* xc = s_xa;
    float* xn = s_xb;
    for (int k = 1; k < n_coeffs; ++k) {
        const float a = sched.a[k];
        for (int idx = tid; idx < NM * NM; idx += NT) {
            const int r = idx / NM, c = idx % NM;
            float acc_v = 0.0f;
            for (int m = 0; m < NM; ++m)
                acc_v = fmaf(s_s[r * NM + m], xc[m * NM + c], acc_v);
            s_t[idx] = (r == c ? 2.0f * a : 0.0f) - (a * a) * acc_v;
        }
        __syncthreads();
        for (int idx = tid; idx < NM * NM; idx += NT) {
            const int r = idx / NM, c = idx % NM;
            float acc_v = 0.0f;
            for (int m = 0; m < NM; ++m)
                acc_v = fmaf(xc[r * NM + m], s_t[m * NM + c], acc_v);
            xn[idx] = acc_v;
        }
        __syncthreads();
        float* tmp = xc;
        xc = xn;
        xn = tmp;
    }
    for (int idx = tid; idx < NM * NM; idx += NT) {   // unbalance
        const int r = idx / NM, c = idx % NM;
        xc[idx] *= s_bal[r] * s_bal[c];
    }
    __syncthreads();

    // ---- 5. gain, state update, Joseph covariance -----------------------
    for (int idx = tid; idx < NS * NM; idx += NT) {
        const int i = idx / NM, c = idx % NM;
        float acc_v = 0.0f;
        for (int m = 0; m < NM; ++m)
            acc_v = fmaf(s_pct[i * NM + m], xc[m * NM + c], acc_v);
        s_k[idx] = acc_v;
    }
    __syncthreads();
    if (tid < NS) {
        float acc_v = 0.0f;
        for (int m = 0; m < NM; ++m)
            acc_v = fmaf(s_k[tid * NM + m], s_err[m], acc_v);
        x_out[b * NS + tid] = s_xbar[tid] + acc_v;
    }
    // I - K C, through C's structure
    for (int idx = tid; idx < NS * NS; idx += NT) {
        const int i = idx / NS, j = idx % NS;
        const float* k = s_k + i * NM;
        float kc;
        if (j < 3) {
            kc = -(k[j] + k[3 + j] + k[6 + j] + k[9 + j]);
        } else if (j < 6) {
            kc = k[9 + j] + k[12 + j] + k[15 + j] + k[18 + j];
        } else {
            const int l = (j - 6) / 3, c = (j - 6) % 3;
            kc = k[3 * l + c] + (c == 2 ? k[24 + l] : 0.0f);
        }
        s_m18[idx] = (i == j ? 1.0f : 0.0f) - kc;
    }
    __syncthreads();
    for (int idx = tid; idx < NS * NS; idx += NT) {   // (I - K C) P-bar
        const int i = idx / NS, j = idx % NS;
        float acc_v = 0.0f;
        for (int m = 0; m < NS; ++m)
            acc_v = fmaf(s_m18[i * NS + m], s_pbar[m * NS + j], acc_v);
        s_p[idx] = acc_v;
    }
    __syncthreads();
    for (int idx = tid; idx < NS * NS; idx += NT) {
        const int i = idx / NS, j = idx % NS;
        float acc_v = 0.0f;
        for (int m = 0; m < NS; ++m)
            acc_v = fmaf(s_p[i * NS + m], s_m18[j * NS + m], acc_v);
        float kr = 0.0f;
        for (int m = 0; m < NM; ++m)
            kr = fmaf(s_k[i * NM + m] * s_r[m], s_k[j * NM + m], kr);
        s_pbar[idx] = acc_v + kr;
    }
    __syncthreads();
    for (int idx = tid; idx < NS * NS; idx += NT) {
        const int i = idx / NS, j = idx % NS;
        s_p[idx] = 0.5f * (s_pbar[idx] + s_pbar[j * NS + i]);
    }
    __syncthreads();

    // ---- 6. xy covariance surgery (A1BasicEKF.cpp:143-147) --------------
    const float det2 = s_p[0] * s_p[NS + 1] - s_p[1] * s_p[NS];
    const bool shrink = det2 > 1e-6f;
    for (int idx = tid; idx < NS * NS; idx += NT) {
        const int i = idx / NS, j = idx % NS;
        float v = s_p[idx];
        if (shrink) {
            if ((i < 2) != (j < 2)) v = 0.0f;
            else if (i < 2) v *= 0.1f;
        }
        p_out[(size_t)b * NS * NS + idx] = v;
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
    observe_ekf_kernel<<<batch, NT, 0, stream>>>(
        x, P, quat, acc, gyro, qpos, qvel, ffoot, mode, rho_opt, rho_fix,
        dt, cfn, flat, sched, n_coeffs, rot, euler, rot_z, fpr, fpa, fvr,
        jf, wav, x_out, p_out, estc);
    return (int)cudaGetLastError();
}
