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

On the card, n = 120 runs the middle steps (all but the last ``hi_tail``)
as 3xTF32 tensor-core products (``csrc/schulz_tc.cuh``; emulated on the
CPU by ``kkt_schulz.matmul_3xtf32``) on one of two routes: a cluster of
:data:`CLUSTER` blocks per matrix up to :data:`CROSSOVER` scenarios, one
block per matrix above it; a schedule with no 3xTF32 step runs K1's FP32
body, as n = 12 does. The route of each launch is counted in
:data:`route_launches`. A cluster launch the
device refuses raises; there is no fallback route.
"""

import ctypes
import functools

import torch

from go1_qp_mpc_controller_torch.ops import _build, kkt_schulz

default_hi_tail = kkt_schulz.default_hi_tail
SIZES = (12, 120)     # the matrix sizes the CUDA kernel is built for
CLUSTER = 8           # blocks per matrix on the cluster route (n = 120)
# the largest batch that takes the cluster route at n = 120; above it one
# block per matrix. chip_smoke.k3_route_phase times both routes at batch
# 1-32: on the H100 the cluster route was the faster one up to batch 16
# (the 8-block clusters of 16 matrices then ran in about two waves), the
# one-block route at 32
CROSSOVER = 16
ROUTES = ("cluster", "cta", "fp32", "n12")

# launches of the CUDA kernel since the last reset (CPU calls do not
# count), in all and by route
launches = 0
route_launches = dict.fromkeys(ROUTES, 0)


def reset_launches():
    global launches
    launches = 0
    route_launches.update(dict.fromkeys(ROUTES, 0))


def route(n, batch, coeffs, hi_tail=None):
    """The route a CUDA launch takes for ``batch`` matrices of size n and
    the schedule ``coeffs`` with FP32 tail ``hi_tail``. At n = 120 a
    schedule that the tail leaves no 3xTF32 step (the warm refinement's one
    step) runs K1's FP32 body ("fp32"): the tensor-core body would only
    add its padding to 128 and its 256-thread FP32 products."""
    if n == 12:
        return "n12"
    if default_hi_tail(coeffs, hi_tail) >= len(coeffs):
        return "fp32"
    return "cluster" if batch <= CROSSOVER else "cta"


# the launch's blocks per matrix for each route (see csrc/schulz_batch.cu)
BLOCKS = {"cluster": CLUSTER, "cta": 1, "fp32": 0, "n12": 1}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("schulz_batch")
    ptr = ctypes.c_void_p
    lib.schulz_batch_launch.argtypes = [
        ptr, ptr, ptr, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
    lib.schulz_batch_launch.restype = ctypes.c_int
    return lib


def _launch(m, x0, coeffs, hi_tail, cluster):
    """One launch of the CUDA kernel with ``cluster`` blocks per matrix
    at n = 120 (:data:`BLOCKS`: 1 or :data:`CLUSTER`, or 0 for the FP32
    body); raises if the launch fails."""
    batch, n = m.shape[0], m.shape[-1]
    out = torch.empty((batch, n, n), dtype=torch.float32, device=m.device)
    sched = (ctypes.c_float * max(len(coeffs), 1))(*coeffs)
    rc = _lib().schulz_batch_launch(
        m.data_ptr(), None if x0 is None else x0.data_ptr(), out.data_ptr(),
        sched, len(coeffs), hi_tail, n, batch, cluster,
        torch.cuda.current_stream(m.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"schulz_inverse_batch: CUDA launch with "
                           f"{cluster} blocks per matrix failed with error "
                           f"{rc}")
    return out


def schulz_inverse_batch(m, x0=None, coeffs=(1.0,), hi_tail=None):
    """K3 entry point: (B, n, n) unbalanced inverses of the unbalanced SPD
    matrices ``m`` (see the module docstring).

    Args:
      m: (B, n, n); on the card n must be one of :data:`SIZES`.
      x0: optional (B, n, n) unbalanced warm inverses (basin-safeguarded).
      coeffs: the step schedule, 0 to 64 steps (1.0 = plain Newton step).
      hi_tail: the last steps that run full FP32 (default 2, at most the
        schedule's length); the others run 3xTF32 on the card at n = 120.
    """
    if len(coeffs) > kkt_schulz.MAX_COEFFS:
        raise ValueError(f"schulz_inverse_batch: schedule of {len(coeffs)} "
                         f"steps; at most {kkt_schulz.MAX_COEFFS} supported")
    hi_tail = default_hi_tail(coeffs, hi_tail)
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
    if batch == 0:
        return torch.empty((0, n, n), dtype=torch.float32, device=m.device)
    way = route(n, batch, coeffs, hi_tail)
    out = _launch(m, x0, coeffs, hi_tail, BLOCKS[way])
    global launches
    launches += 1
    route_launches[way] += 1
    return out
