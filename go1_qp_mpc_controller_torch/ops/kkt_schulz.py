"""K1: fused KKT build + Newton-Schulz inverse, per scenario.

Port of the JAX package's Pallas kernel
``ops/pallas_admm.py::schulz_inverse_kkt_batch`` (``_kkt_build_tile`` +
``_schulz_batch_body``). For each scenario it

1. builds M = cost H + sigma I + C' diag(rho) C from the lazy Gram
   quadrants (``srb.LazyCondensedQP.tiled``) times the constant
   ``srb._NILP_COEFFS_E`` plus the three band diagonals,
2. Jacobi-balances M (M_b = S M S, S = diag(M)^-1/2),
3. with a warm start X0, runs the basin test on M_b X0_b (min diagonal
   > 1e-4 and max absolute row sum < 3): a passing scenario takes a plain
   Newton step from X0, a failing one the scaled cold step,
4. runs the rest of the coefficient schedule
   (``admm._scaled_schulz_coeffs``; scaled steps apply only to scenarios
   that did not accept their warm start),
5. returns the unbalanced inverse S X S.

``kkt_schulz`` is the entry point: a CUDA float32 input launches the
hand-written Hopper kernel ``csrc/kkt_schulz.cu``; a CPU input takes the
plain PyTorch version ``kkt_schulz_plain`` below (any dtype). Any other
input raises.

Precision, as the JAX package's: the steps before the last ``hi_tail``
(the TPU's bf16x3) run 3xTF32 on the card's tensor cores (emulated on the
CPU by :func:`matmul_3xtf32`, passed as ``middle_matmul``); the tail, the
basin test and the accepted warm step run FP32. The card takes one of
two routes (:func:`route`), by schedule: one with a 3xTF32 step runs
``csrc/schulz_tc.cuh``'s one-block body, a block a scenario ("cta"); one
without runs the FP32 body with bulk-staged operands ("fp32"). Launches
are counted in :data:`launches` and by route in :data:`route_launches`.
A launch that fails raises; there is no fallback route.
"""

import ctypes
import functools

import torch

from go1_qp_mpc_controller_torch.models import srb
from go1_qp_mpc_controller_torch.ops import _build

N = srb.H * srb.NU          # 120
MAX_COEFFS = 64             # schedule capacity of the CUDA kernel
ROUTES = ("cta", "fp32")
# the launch's route argument for each (see csrc/kkt_schulz.cu)
BLOCKS = {"cta": 1, "fp32": 0}

# launches of the CUDA kernel since the last reset (CPU calls do not
# count), in all and by route
launches = 0
route_launches = dict.fromkeys(ROUTES, 0)


def reset_launches():
    global launches
    launches = 0
    route_launches.update(dict.fromkeys(ROUTES, 0))


def default_hi_tail(coeffs, hi_tail=None):
    """The FP32 tail of a schedule: ``hi_tail`` (default 2), at most its
    length (``pallas_admm.schulz_inverse_kkt_batch``'s rule)."""
    return min(len(coeffs), 2 if hi_tail is None else hi_tail)


def route(coeffs, hi_tail=None):
    """The route a CUDA launch of K1 takes for the schedule ``coeffs`` with
    FP32 tail ``hi_tail``, at any batch: "cta" for a schedule with a
    3xTF32 step, "fp32" for one without."""
    return "cta" if default_hi_tail(coeffs, hi_tail) < len(coeffs) else "fp32"


def band_matrix(main, off1, off2):
    """(B, n, n) symmetric band matrix from its diagonals: ``main``, then
    ``off1`` at +-1 and ``off2`` at +-2 (each stored at the smaller index;
    their last 1 and 2 entries are unused)."""
    return (torch.diag_embed(main)
            + torch.diag_embed(off1[..., :-1], 1)
            + torch.diag_embed(off1[..., :-1], -1)
            + torch.diag_embed(off2[..., :-2], 2)
            + torch.diag_embed(off2[..., :-2], -2))


def kkt_build_plain(tiled, dmain, off1, off2, cost):
    """Materialized (B, n, n) M = cost H + band (the kernel's build step).

    Args:
      tiled: (B, 4, 12, n) lazy Gram quadrants.
      dmain, off1, off2: (B, n) band diagonals; dmain holds everything of
        M's diagonal except H's own (cost r_diag + sigma + band main).
      cost: (B,) cost normalization 1 / max diag H.
    """
    batch, n = tiled.shape[0], tiled.shape[-1]
    coef = srb._const("coeffs_e", tiled)                   # (4, H, n)
    acc = coef[0][None, :, None, :] * tiled[:, 0][:, None]
    for k in range(1, 4):
        acc = acc + coef[k][None, :, None, :] * tiled[:, k][:, None]
    return (cost[:, None, None] * acc.reshape(batch, n, n)
            + band_matrix(dmain, off1, off2))


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits) as the card's
    ``cvt.rna.tf32.f32`` does, bit for bit: to nearest, ties away from
    zero (add 0x1000 to the magnitude bits, clear the low 13); NaN and
    infinity pass through, and a magnitude past the largest TF32 rounds
    to infinity."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round: float32 input, got {x.dtype}")
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0xFFFFE000
    out = (mag | (bits & 0x80000000)).to(torch.int32)   # wraps to int32
    return torch.where(torch.isfinite(x), out.view(torch.float32), x)


def matmul_3xtf32(a, b):
    """The product of the n = 120 kernels' middle steps (K3, K5), emulated
    in float32: each operand split as hi = tf32(x), lo = tf32(x - hi), and
    lo hi + hi lo summed before hi hi. The card sums each m16n8k8 tile in
    its own order, so the kernel agrees with this to float32 round-off,
    not bit for bit."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def schulz_balanced_core(mb, x0b=None, coeffs=(1.0,), hi_tail=None,
                         middle_matmul=None):
    """Basin-safeguarded (scaled) Newton-Schulz on already-balanced
    (B, n, n) matrices; returns the BALANCED inverse (the kernels' Schulz
    step, ``_schulz_batch_body`` between balance and unbalance).

    Args:
      mb: (B, n, n) Jacobi-balanced matrices.
      x0b: optional (B, n, n) balanced warm inverses.
      coeffs: per-step schedule (1.0 = plain Newton step). An empty
        schedule returns the warm start where it passes the basin test and
        the scalar cold init c I elsewhere (c I without a warm start).
      hi_tail, middle_matmul: with ``middle_matmul`` (e.g.
        :func:`matmul_3xtf32`), the steps before the last ``hi_tail``
        (default 2, at most the schedule's length) take both products
        from it; the basin test, the accepted warm step and the tail keep
        ``@``. Without it every product is ``@`` (the default).
    """
    n = mb.shape[-1]
    tail = min(len(coeffs), 2 if hi_tail is None else hi_tail)
    eye = torch.eye(n, dtype=mb.dtype, device=mb.device)
    eye2 = 2.0 * eye
    norminf = torch.amax(torch.sum(torch.abs(mb), dim=-1), dim=-1)
    c = (1.0 / (1.05 * norminf))[:, None, None]
    start = 0
    ok = None
    if x0b is not None:
        inner = mb @ x0b
        row_inner = torch.sum(torch.abs(inner), dim=-1)
        d = torch.diagonal(inner, dim1=-2, dim2=-1)
        # amin/amax propagate NaN like jnp.min/max: a NaN scenario fails
        ok = ((torch.amin(d, dim=-1) > 1e-4)
              & (torch.amax(row_inner, dim=-1) < 3.0))[:, None, None]
        if not coeffs:
            return torch.where(ok, x0b, c * eye)
        stepped = x0b @ (eye2 - inner)
        ac = coeffs[0] * c
        stepped_cold = ac * (eye2 - ac * mb)
        x = torch.where(ok, stepped, stepped_cold)
        start = 1
    elif coeffs:
        # the first step from the scalar cold init c I, folded (exact for
        # any coefficient, the plain a = 1 included): no product
        ac = coeffs[0] * c
        x = ac * (eye2 - ac * mb)
        start = 1
    else:
        x = c * eye
    for k in range(start, len(coeffs)):
        a = coeffs[k]
        mm = (middle_matmul if middle_matmul is not None
              and k < len(coeffs) - tail else torch.matmul)
        inner = mm(mb, x)
        if a == 1.0:
            x = mm(x, eye2 - inner)
        else:
            # scaled step X <- a X (2I - a M X); warm-accepted scenarios
            # run plain Newton (a = 1)
            aa = (a if ok is None
                  else torch.where(ok, 1.0, a).to(mb.dtype))
            x = mm(x, (2.0 * aa) * eye - (aa * aa) * inner)
    return x


def schulz_balanced_plain(m, x0=None, coeffs=(1.0,), hi_tail=None,
                          middle_matmul=None):
    """Balance + :func:`schulz_balanced_core` + unbalance on (B, n, n)
    UNBALANCED SPD matrices with optional unbalanced warm inverses: the
    plain PyTorch version of K3 (``ops/schulz_batch.py``), and K1's after
    the KKT build. ``hi_tail`` and ``middle_matmul`` as in
    :func:`schulz_balanced_core`."""
    s = torch.rsqrt(torch.diagonal(m, dim1=-2, dim2=-1))
    unb = s[:, :, None] * s[:, None, :]
    x0b = None if x0 is None else x0 / unb
    return schulz_balanced_core(m * unb, x0b, coeffs, hi_tail,
                                middle_matmul) * unb


def kkt_schulz_plain(tiled, dmain, off1, off2, cost, x0=None,
                     coeffs=(1.0,), hi_tail=None, middle_matmul=None):
    """Plain PyTorch version of K1 (the arguments of :func:`kkt_schulz`);
    ``hi_tail`` and ``middle_matmul`` as in :func:`schulz_balanced_core`
    (with ``middle_matmul=matmul_3xtf32``, the card's middle steps)."""
    m = kkt_build_plain(tiled, dmain, off1, off2, cost)
    return schulz_balanced_plain(m, x0, coeffs, hi_tail, middle_matmul)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("kkt_schulz")
    ptr = ctypes.c_void_p
    lib.kkt_schulz_launch.argtypes = [ptr] * 8 + [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ptr]
    lib.kkt_schulz_launch.restype = ctypes.c_int
    return lib


def check_cuda_f32(kernel, name, t, shape):
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of ``shape``."""
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise TypeError(f"{kernel}: {name} must be a float32 CUDA tensor, "
                        f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def _launch(tiled, dmain, off1, off2, cost, x0, coeffs, hi_tail, blocks):
    """One launch of the CUDA kernel on the route ``blocks``
    (:data:`BLOCKS`: 0 "fp32", 1 "cta"; the kernel refuses any other
    value); raises if the launch fails."""
    batch = tiled.shape[0]
    if blocks == 0:
        # the bulk copies of the "fp32" route need 16-byte aligned rows
        for name, t in (("tiled", tiled), ("dmain", dmain), ("off1", off1),
                        ("off2", off2), ("x0", x0)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"kkt_schulz: {name} must be 16-byte "
                                 f"aligned on the fp32 route")
    out = torch.empty((batch, N, N), dtype=torch.float32,
                      device=tiled.device)
    sched = (ctypes.c_float * len(coeffs))(*coeffs)
    rc = _lib().kkt_schulz_launch(
        tiled.data_ptr(), dmain.data_ptr(), off1.data_ptr(),
        off2.data_ptr(), cost.data_ptr(),
        srb._const("coeffs_e", tiled).data_ptr(),
        None if x0 is None else x0.data_ptr(), out.data_ptr(),
        sched, len(coeffs), hi_tail, batch, blocks,
        torch.cuda.current_stream(tiled.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kkt_schulz: CUDA launch with blocks={blocks} "
                           f"failed with error {rc}")
    return out


def kkt_schulz(tiled, dmain, off1, off2, cost, x0=None, coeffs=(1.0,),
               hi_tail=None):
    """K1 entry point: (B, n, n) unbalanced inverses of
    cost H + sigma I + C' diag(rho) C (see the module docstring).

    Args:
      tiled: (B, 4, 12, 120); dmain, off1, off2: (B, 120); cost: (B,).
      x0: optional (B, 120, 120) unbalanced warm inverses.
      coeffs: the step schedule (1 to 64 steps).
      hi_tail: the last steps that run full FP32 (default 2, at most the
        schedule's length); the others run 3xTF32 on the card. The CPU
        path runs every product in the input's dtype.
    """
    if not 0 < len(coeffs) <= MAX_COEFFS:
        raise ValueError(f"kkt_schulz: schedule of {len(coeffs)} steps; "
                         f"1..{MAX_COEFFS} supported")
    hi_tail = default_hi_tail(coeffs, hi_tail)
    if tiled.device.type == "cpu":
        return kkt_schulz_plain(tiled, dmain, off1, off2, cost, x0, coeffs,
                                hi_tail)
    batch = tiled.shape[0]
    check_cuda_f32("kkt_schulz", "tiled", tiled, (batch, 4, srb.NU, N))
    for name, t in (("dmain", dmain), ("off1", off1), ("off2", off2)):
        check_cuda_f32("kkt_schulz", name, t, (batch, N))
    check_cuda_f32("kkt_schulz", "cost", cost, (batch,))
    if x0 is not None:
        check_cuda_f32("kkt_schulz", "x0", x0, (batch, N, N))
    if batch == 0:
        return torch.empty((0, N, N), dtype=torch.float32,
                           device=tiled.device)
    way = route(coeffs, hi_tail)
    out = _launch(tiled, dmain, off1, off2, cost, x0, coeffs, hi_tail,
                  BLOCKS[way])
    global launches
    launches += 1
    route_launches[way] += 1
    return out
