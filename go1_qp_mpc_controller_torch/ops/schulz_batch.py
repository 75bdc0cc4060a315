"""K3: Newton-Schulz inverse of already-built dense KKT matrices.

Port of the JAX package's Pallas kernel
``ops/pallas_admm.py::schulz_inverse_batch`` (``_schulz_batch_body``). For
each scenario of an UNBALANCED SPD batch (B, n, n) it Jacobi-balances the
matrix, runs the basin-safeguarded (scaled) Newton-Schulz schedule from the
optional warm start and returns the unbalanced inverse: the same body as
K1 (``ops/kkt_schulz.py``) without the KKT build. The dense solver's KKT
solves reach it (``admm._schulz_inverse``) at n = 120 (MPC) and n = 12
(the balance QP).

``schulz_inverse_batch`` is the entry point: a float32 CUDA input launches
the hand-written Hopper kernel ``csrc/schulz_batch.cu``; a CPU input takes
the plain PyTorch version ``kkt_schulz.schulz_balanced_plain`` (any
dtype). Any other input raises.
"""

import ctypes
import functools

import torch

from go1_qp_mpc_controller_torch.ops import _build, kkt_schulz

SIZES = (12, 120)     # the matrix sizes the CUDA kernel is built for

# launches of the CUDA kernel since the last reset (CPU calls do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("schulz_batch")
    ptr = ctypes.c_void_p
    lib.schulz_batch_launch.argtypes = [
        ptr, ptr, ptr, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ptr]
    lib.schulz_batch_launch.restype = ctypes.c_int
    return lib


def schulz_inverse_batch(m, x0=None, coeffs=(1.0,)):
    """K3 entry point: (B, n, n) unbalanced inverses of the unbalanced SPD
    matrices ``m`` (see the module docstring).

    Args:
      m: (B, n, n); on the card n must be one of :data:`SIZES`.
      x0: optional (B, n, n) unbalanced warm inverses (basin-safeguarded).
      coeffs: the step schedule, 0 to 64 steps (1.0 = plain Newton step).
    """
    if len(coeffs) > kkt_schulz.MAX_COEFFS:
        raise ValueError(f"schulz_inverse_batch: schedule of {len(coeffs)} "
                         f"steps; at most {kkt_schulz.MAX_COEFFS} supported")
    if m.device.type == "cpu":
        return kkt_schulz.schulz_balanced_plain(m, x0, coeffs)
    batch, n = m.shape[0], m.shape[-1]
    if n not in SIZES:
        raise ValueError(f"schulz_inverse_batch: the CUDA kernel is built "
                         f"for n in {SIZES}, got n = {n}")
    check = kkt_schulz.check_cuda_f32
    check("schulz_inverse_batch", "m", m, (batch, n, n))
    if x0 is not None:
        check("schulz_inverse_batch", "x0", x0, (batch, n, n))
    out = torch.empty((batch, n, n), dtype=torch.float32, device=m.device)
    if batch == 0:
        return out
    sched = (ctypes.c_float * max(len(coeffs), 1))(*coeffs)
    rc = _lib().schulz_batch_launch(
        m.data_ptr(), None if x0 is None else x0.data_ptr(), out.data_ptr(),
        sched, len(coeffs), n, batch,
        torch.cuda.current_stream(m.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"schulz_inverse_batch: CUDA launch failed with "
                           f"error {rc}")
    global launches
    launches += 1
    return out
