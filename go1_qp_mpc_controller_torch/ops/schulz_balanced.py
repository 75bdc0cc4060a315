"""K5: Newton-Schulz inverse of one already-balanced matrix.

Port of the JAX package's Pallas kernel
``ops/pallas_admm.py::schulz_balanced`` (``_schulz_kernel``): ``iters``
plain Newton-Schulz steps on a Jacobi-balanced matrix from the cold init
I / (1.05 ||M_b||_inf), or from a basin-safeguarded warm start, returning
the BALANCED inverse (the caller unbalances with its own scale). It is the
Schulz body of K3 without the balance and unbalance. In the JAX package
only tests call it; here it is its own entry point too.

``schulz_balanced`` is the entry point: a float32 CUDA input launches the
hand-written Hopper kernel ``csrc/schulz_balanced.cu`` (n = 120, one
cluster of :data:`CLUSTER` blocks for the one matrix; the middle steps
3xTF32 on the tensor cores, the last ``min(iters, 2)`` in FP32, as the
TPU kernel's HIGH middles and HIGHEST tail); a CPU input takes the plain
PyTorch version ``schulz_balanced_plain`` (any dtype and size). Any other
input raises, a refused cluster launch too.
"""

import ctypes
import functools

import torch

from go1_qp_mpc_controller_torch.ops import _build, kkt_schulz

N = 120           # the matrix size the CUDA kernel is built for
CLUSTER = 8       # blocks of the one matrix

# launches of the CUDA kernel since the last reset (CPU calls do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


def schulz_balanced_plain(m_b, iters, x0_b=None, hi_tail=None,
                          middle_matmul=None):
    """Plain PyTorch version of K5 (same signature):
    ``kkt_schulz.schulz_balanced_core`` with ``iters`` plain steps; with
    ``middle_matmul`` (e.g. ``kkt_schulz.matmul_3xtf32``) the steps before
    the last ``hi_tail`` (default ``min(iters, 2)``) take their products
    from it."""
    x0 = None if x0_b is None else x0_b[None]
    return kkt_schulz.schulz_balanced_core(
        m_b[None], x0, (1.0,) * iters, hi_tail=hi_tail,
        middle_matmul=middle_matmul)[0]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("schulz_balanced")
    ptr = ctypes.c_void_p
    lib.schulz_balanced_launch.argtypes = [
        ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
    lib.schulz_balanced_launch.restype = ctypes.c_int
    return lib


def _launch(m_b, iters, x0_b, cluster):
    """One launch of the CUDA kernel on a cluster of ``cluster`` blocks;
    raises if the launch fails."""
    out = torch.empty((N, N), dtype=torch.float32, device=m_b.device)
    rc = _lib().schulz_balanced_launch(
        m_b.data_ptr(), None if x0_b is None else x0_b.data_ptr(),
        out.data_ptr(), int(iters), min(int(iters), 2), cluster,
        torch.cuda.current_stream(m_b.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"schulz_balanced: CUDA launch on a cluster of "
                           f"{cluster} blocks failed with error {rc}")
    return out


def schulz_balanced(m_b, iters, x0_b=None):
    """K5 entry point: the (n, n) balanced inverse of the balanced matrix
    ``m_b`` after ``iters`` (0 to 64) plain Newton-Schulz steps, from the
    optional balanced warm start ``x0_b`` where it passes the basin test;
    on the card n must be 120."""
    if not 0 <= iters <= kkt_schulz.MAX_COEFFS:
        raise ValueError(f"schulz_balanced: {iters} steps; 0.."
                         f"{kkt_schulz.MAX_COEFFS} supported")
    if m_b.device.type == "cpu":
        return schulz_balanced_plain(m_b, iters, x0_b)
    check = kkt_schulz.check_cuda_f32
    check("schulz_balanced", "m_b", m_b, (N, N))
    if x0_b is not None:
        check("schulz_balanced", "x0_b", x0_b, (N, N))
    out = _launch(m_b, iters, x0_b, CLUSTER)
    global launches
    launches += 1
    return out
