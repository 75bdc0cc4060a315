"""K4: scaled Newton-Schulz inverse of small SPD matrices (the EKF's 28 x 28
innovation matrices).

Port of the JAX package's Pallas kernel
``ops/pallas_admm.py::schulz_inverse_lanes`` (``schulz_lanes_body``). For
each matrix of an UNBALANCED SPD batch (B, 28, 28) it Jacobi-balances the
matrix, runs the cold scaled schedule (first step folded) and returns the
unbalanced inverse. The EKF's innovation inverse reaches it
(``ekf.update_estimation(..., sinv="auto")`` on float32 CUDA input), as the
runtime's estimator thread runs it once a sensor frame.

``schulz_inverse_lanes`` is the entry point: a float32 CUDA input launches
the hand-written Hopper kernel ``csrc/schulz_lanes.cu``; a CPU input takes
the plain PyTorch version ``kkt_schulz.schulz_balanced_plain`` at the same
coefficients (any dtype). Any other input raises.
"""

import ctypes
import functools

import torch

from go1_qp_mpc_controller_torch.ops import _build, kkt_schulz

N = 28            # the matrix size the CUDA kernel is built for

# launches of the CUDA kernel since the last reset (CPU calls do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


def schulz_inverse_lanes_plain(m, coeffs):
    """Plain PyTorch version of K4 (same signature)."""
    return kkt_schulz.schulz_balanced_plain(m, None, tuple(coeffs))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("schulz_lanes")
    ptr = ctypes.c_void_p
    lib.schulz_lanes_launch.argtypes = [
        ptr, ptr, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ptr]
    lib.schulz_lanes_launch.restype = ctypes.c_int
    return lib


def _launch(m, coeffs):
    """One launch of the CUDA kernel; raises if the launch fails."""
    batch = m.shape[0]
    kkt_schulz.check_cuda_f32("schulz_inverse_lanes", "m", m, (batch, N, N))
    out = torch.empty((batch, N, N), dtype=torch.float32, device=m.device)
    if batch == 0:
        return out
    sched = (ctypes.c_float * len(coeffs))(*coeffs)
    rc = _lib().schulz_lanes_launch(
        m.data_ptr(), out.data_ptr(), sched, len(coeffs), batch,
        torch.cuda.current_stream(m.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"schulz_inverse_lanes: CUDA launch failed with "
                           f"error {rc}")
    global launches
    launches += 1
    return out


def schulz_inverse_lanes(m, coeffs):
    """K4 entry point: (B, n, n) unbalanced inverses of the unbalanced SPD
    matrices ``m`` by the cold scaled schedule ``coeffs`` (1 to 64 steps,
    ``admm._scaled_schulz_coeffs``); on the card n must be 28."""
    if not 0 < len(coeffs) <= kkt_schulz.MAX_COEFFS:
        raise ValueError(f"schulz_inverse_lanes: schedule of {len(coeffs)} "
                         f"steps; 1..{kkt_schulz.MAX_COEFFS} supported")
    if m.device.type == "cpu":
        return schulz_inverse_lanes_plain(m, coeffs)
    return _launch(m, coeffs)
