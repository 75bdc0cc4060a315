"""Static flop / byte accounting of the solver programs against the card.

Port of the JAX package's ``utils/roofline.py``. Per program, count the
useful matmul flops, the elementwise flops and the minimal HBM traffic
implied by the static shapes, then compare a measured rate with the
card's peaks. The stage functions and their counts are the JAX package's:
they describe the work, not the chip, so for equal settings the per-item
flops and bytes equal the JAX model's. The port always runs its kernels
(K1 builds the KKT inside the Schulz kernel whatever ``schulz_impl``
names), so its counts are the JAX model's "pallas" ones.

What changes is the price of each flop, charged at the precision it runs
in on this card (``utils/device.py::pin_f32_matmuls`` pins true-float32
products everywhere else):

- 3xTF32 (three passes at the dense TF32 tensor-core peak): the middle
  steps of the n = 120 Newton-Schulz schedules, that is K1's
  (``csrc/kkt_schulz.cu`` "cta") and K3's at n = 120
  (``csrc/schulz_batch.cu``);
- FP32 (outside the tensor cores): the last ``hi_tail`` steps of those
  schedules, K2 (observe + EKF), K4 (the EKF innovation inverse), K6 (the
  ADMM iterations), K3 at n = 12, the condensation and every
  elementwise stage.

Conventions:
  - ``matmul_flops`` are useful algorithmic flops (2mnk a product);
    ``tf32x3_flops`` is the part of them that runs as 3xTF32.
  - The operations' time is (FP32 flops) / FP32 peak + 3 x (3xTF32
    flops) / TF32 peak, the bytes' time the minimal HBM traffic over the
    HBM peak; the bound is the larger ("operations" or "bytes"), as in
    ``chip_smoke.py``'s kernel bounds.
  - Byte counts are the minimal traffic of each stage's inputs and
    outputs (perfect fusion inside a stage, no reuse across stages).
  - ``mfu`` is all useful flops against the card's dense BF16 peak, as
    the JAX package's is against the TPU's bf16 peak.
"""

from typing import NamedTuple

from go1_qp_mpc_controller_torch.config import params as P

NV = P.MPC_NV            # 120 variables
NVP = 128                # the JAX package's padded KKT dim
NCON = P.MPC_CONSTRAINT_DIM * P.PLAN_HORIZON   # 200 constraints
NX = P.MPC_STATE_DIM     # 13
H = P.PLAN_HORIZON       # 10
F32 = 4                  # bytes


class Stage(NamedTuple):
    """One accounted stage of a program (per scenario)."""
    name: str
    matmul_flops: float       # useful matmul flops
    tf32x3_flops: float       # the part of matmul_flops run as 3xTF32
    elementwise_flops: float  # elementwise flops (FP32)
    hbm_bytes: float          # minimal HBM traffic (reads + writes)


class DevicePeaks(NamedTuple):
    name: str
    bf16_flops: float     # dense BF16 tensor-core flops/s (mfu's peak)
    tf32_flops: float     # dense TF32 tensor-core flops/s (one pass)
    fp32_flops: float     # FP32 flops/s outside the tensor cores
    hbm_bytes: float      # HBM bytes/s
    known: bool           # False -> nominal placeholder peaks


# NVIDIA's H100 data sheet, SXM part (HBM3), dense rates without sparsity,
# at the full 700 W power limit
H100_SXM = DevicePeaks("NVIDIA H100 SXM", 989e12, 495e12, 67e12, 3.35e12,
                       True)
_CPU = DevicePeaks("host CPU (nominal)", 1e12, 1e12, 0.5e12, 100e9, False)


def _peaks_of(kind):
    """DevicePeaks of a card named ``kind`` (``torch.cuda.get_device_name``
    form); any card but the H100 SXM part gets its peaks, renamed, with
    ``known=False``."""
    low = kind.lower()
    if "h100" in low and ("hbm3" in low or "sxm" in low):
        return H100_SXM
    return H100_SXM._replace(name=kind, known=False)


def device_peaks(device=None):
    """DevicePeaks of a torch device (default: the CUDA card if there is
    one, else the CPU); the CPU gets nominal peaks with ``known=False``."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return _CPU
    return _peaks_of(torch.cuda.get_device_name(device))


# --------------------------------------------------------------------------
# stage functions (per scenario)

def _matmul(m, n, k):
    return 2.0 * m * n * k


def _schulz_schedule_stages(name, n_steps, first_cold_analytic, hi_tail,
                            warm_start, n=NVP, fused_kkt=False):
    """The kernel Newton-Schulz schedule (K3 ``schulz_inverse_batch``, K1
    ``kkt_schulz``).

    Matmul count: the cold-analytic first step is elementwise (the iterate
    is a scalar multiple of I); every other step is 2 (n, n) products; a
    warm start adds the basin inner product inside step 0. The middle
    steps run 3xTF32, the ``hi_tail`` tail FP32. HBM: M in + inverse out
    (+ x0 in when warm); the iterates stay on chip. With ``fused_kkt``
    (K1) the KKT is built in the kernel from the lazy factors: only tiled
    (4*12*n) + band diagonals cross HBM, and the build adds elementwise
    work.
    """
    mm = _matmul(n, n, n)
    n_mm = 2.0 * n_steps
    if first_cold_analytic and not warm_start:
        n_mm -= 2.0          # step 0 costs no product from the scalar init
    hi_mm = 2.0 * min(hi_tail, n_steps)
    lo_mm = max(n_mm - hi_mm, 0.0)
    ew = 10.0 * n * n        # balance / unbalance + masks
    if fused_kkt:
        m_in = (4 * 12 * n + 4 * n) * F32     # tiled + band diagonals
        ew += 16.0 * n * n                     # in-kernel H + band build
    else:
        m_in = n * n * F32
    bytes_ = m_in + n * n * F32 + (n * n * F32 if warm_start else 0)
    return Stage(name, n_mm * mm, lo_mm * mm, ew, bytes_)


def _admm_iter_stage(name, iters, n=NV, m=NCON):
    """K6's ADMM segment: per iteration one (n, n) matvec plus ~10
    streamed vector passes (rhs build, constraint matvecs, projection,
    dual update) whose HBM traffic rides along."""
    matvec = _matmul(n, n, 1)
    vec_bytes = 16.0 * m * F32              # ~8 read + 8 write passes
    return Stage(name, iters * matvec, 0.0, iters * 20.0 * m,
                 iters * (n * n * F32 + vec_bytes))


def _condense_lazy_stage(name="condense_lazy"):
    """condense_nilpotent_lazy: gram + expand products + gradient suffix
    sums; writes the factored tiled (4, 12, 120) + gradient."""
    fl = (_matmul(24, 24, NX)          # gram
          + _matmul(48, H * P.NUM_DOF, P.NUM_DOF)   # quad expand
          + _matmul(H, P.NUM_DOF, 26)  # gradient contract
          + 3 * _matmul(NX, NX, NX))   # N products / residual polynomial
    bytes_ = (4 * P.NUM_DOF * NV + NV + 2 * NCON + H * NX) * F32
    return Stage(name, fl, 0.0, 2e3, bytes_)


def _residual_stage(name="residuals"):
    """Warm-finish diagnostics: lazy Hessian matvec (4x MAC overhead) +
    constraint matvecs."""
    return Stage(name, 4 * _matmul(NV, 1, NV), 0.0, 10.0 * NCON,
                 (4 * P.NUM_DOF * NV + 4 * NCON) * F32)


def warm_tick_stages(settings):
    """The warm tick (``admm.mpc_solve_warm_fused``), per scenario: K1
    builds the KKT inside the Schulz kernel, so no separate KKT stage."""
    refine = settings.schulz_refine
    return [
        _condense_lazy_stage(),
        _schulz_schedule_stages(
            "schulz_refine", refine, first_cold_analytic=False,
            hi_tail=min(refine, 2), warm_start=True, fused_kkt=True),
        _admm_iter_stage("admm_iters", settings.seg_iters),
        _residual_stage(),
    ]


def cold_solve_stages(settings):
    """Cold MPC solve, per scenario. segments == 1 models the fused
    single-segment program (``admm.mpc_solve_cold``: K1 on the lazy
    factors, one scaled Schulz schedule at the analytic rho0); segments >
    1 models the segmented dense solve (dense condensation + per-segment
    KKT rebuild + Schulz + iteration block)."""
    from go1_qp_mpc_controller_torch.ops import admm

    if settings.segments == 1:
        l0 = settings.schulz_l0 if settings.schulz_l0 > 0 else 1e-6
        n_steps = len(admm._scaled_schulz_coeffs(l0))
        return [
            _condense_lazy_stage(),
            _schulz_schedule_stages(
                "schulz_cold", n_steps, first_cold_analytic=True,
                hi_tail=settings.schulz_hi_tail, warm_start=False,
                fused_kkt=True),
            _admm_iter_stage("admm_iters", settings.seg_iters),
            _residual_stage(),
        ]

    stages = [
        _condense_lazy_stage(),
        # lazy_hessian materialization + cost scaling + fused KKT build:
        # ~3 passes over the (120, 120) output
        Stage("hessian+kkt", 0.0, 0.0, 30.0 * NV * NV, 3 * NV * NV * F32),
    ]
    for seg in range(settings.segments):
        iters = (settings.first_seg_iters
                 if (seg == 0 and settings.first_seg_iters > 0)
                 else settings.seg_iters)
        if seg == 0:
            l0 = settings.schulz_l0_first or settings.schulz_l0
            warm = False
        else:
            l0 = settings.schulz_l0_refine or settings.schulz_l0
            warm = True
            stages.append(Stage(f"kkt_rebuild_{seg}", 0.0, 0.0,
                                20.0 * NV * NV, 2 * NV * NV * F32))
        if l0 > 0:
            n_steps = len(admm._scaled_schulz_coeffs(l0))
        else:
            n_steps = settings.schulz_iters
        stages.append(_schulz_schedule_stages(
            f"schulz_seg{seg}", n_steps, first_cold_analytic=True,
            hi_tail=settings.schulz_hi_tail, warm_start=warm))
        stages.append(_admm_iter_stage(f"admm_seg{seg}", iters))
    stages.append(_residual_stage())
    return stages


def ekf_stages(schulz_steps=11):
    """sensor_update: the FK / quaternion / Jacobian observe stage + the
    18 / 28 EKF tick (predict, the innovation Schulz inverse, Joseph
    update), per scenario; K2 and K4 run all of it in FP32."""
    ns, nm = 18, 28
    ekf_mm = (2 * _matmul(ns, ns, ns)       # A P A'
              + _matmul(nm, ns, ns) + _matmul(nm, nm, ns)   # C P C'
              + _matmul(ns, nm, nm)         # K = P C' Sinv
              + _matmul(ns, ns, nm)         # K C
              + 2 * _matmul(ns, ns, ns)     # Joseph ikc P ikc'
              + _matmul(ns, nm, ns))        # K R K' (diag R)
    lanes = 2 * schulz_steps * _matmul(nm, nm, nm)
    observe = 4 * (200.0 + 2 * _matmul(3, 3, 3) + _matmul(3, 1, 3))
    state_bytes = (ns * ns + nm * nm + 4 * ns + 3 * nm) * F32
    return [
        Stage("observe_fk", 0.0, 0.0, observe + 2000.0, 120 * F32),
        Stage("ekf_dense", ekf_mm, 0.0, 3000.0, 3 * state_bytes),
        Stage("ekf_schulz_lanes", 0.0, 0.0, lanes, 2 * nm * nm * F32),
    ]


def ctrl_tick_stages(warm_settings, ekf_schulz_steps=11):
    """Full controller tick: observe + EKF + plan / swing (elementwise) +
    warm MPC + torques + SRB plant step."""
    return (ekf_stages(ekf_schulz_steps)
            + [Stage("plan_swing_torque_plant", 4 * _matmul(3, 3, 3), 0.0,
                     5e3, 400 * F32)]
            + warm_tick_stages(warm_settings))


# --------------------------------------------------------------------------

def summarize(stages, items_per_s, peaks):
    """Roofline summary dict of a measured program.

    Args:
      stages: list of per-item Stage entries.
      items_per_s: measured throughput (solves/s, ticks/s, ...).
      peaks: DevicePeaks.

    Returns:
      dict with the per-item flop / byte totals, the achieved fractions
      and the bound ("operations" | "bytes"), under the JAX package's
      keys (``mxu_flops_per_item`` holds the matmul flops).
    """
    mm = sum(s.matmul_flops for s in stages)
    tc = sum(s.tf32x3_flops for s in stages)
    ew = sum(s.elementwise_flops for s in stages)
    byts = sum(s.hbm_bytes for s in stages)
    t_ops = (mm - tc + ew) / peaks.fp32_flops + 3.0 * tc / peaks.tf32_flops
    t_hbm = byts / peaks.hbm_bytes
    t_bound = max(t_ops, t_hbm)
    return {
        "flops_per_item": round(mm + ew, 1),
        "mxu_flops_per_item": round(mm, 1),
        "hbm_bytes_per_item": round(byts, 1),
        "mfu": round((mm + ew) * items_per_s / peaks.bf16_flops, 5),
        "hbm_frac": round(byts * items_per_s / peaks.hbm_bytes, 4),
        "roofline_items_per_s": round(1.0 / t_bound, 1),
        "roofline_frac": round(items_per_s * t_bound, 4),
        "bound": "operations" if t_ops >= t_hbm else "bytes",
        "device_peaks_known": peaks.known,
    }
