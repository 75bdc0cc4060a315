"""The work of one call of the sweep's dense polished solve (``main.py
sweep``'s program), counted from its shapes and settings alone, and the
least time an H100 could take for it.

The counts are of what the mathematics needs, whatever implements it:

- K3 (``ops/schulz_batch``), once a segment on each scenario's n x n KKT
  matrix: Newton-Schulz steps X <- X (2I - M X), two n x n x n products
  (4 n^3 operations) a step. The first segment starts cold from a scaled
  identity, whose first step needs no product; the later segments start
  from the previous inverse and run the whole schedule. Bytes: M read and
  X written, and the warm start read where there is one.
- K6 (``ops/admm_iterations``), once a segment: ``seg_iters`` ADMM
  iterations, each one product with the n x n inverse (2 n^2) and, on the
  friction pyramid's 360 non-zeros, C x and C' y (2 x 720), and about 12
  operations a constraint row and 6 a variable for the relaxation, the
  projection and the dual step. Bytes: the inverse, the gradient, the
  bounds and the per-row rho read, the iterate read and written.

Prices: products at the fastest rate at which an H100 gives a
float32-accurate result (3xTF32 on the tensor cores: the TF32 peak over
three), other float32 operations at the float32 peak outside the tensor
cores, bytes at the HBM peak (NVIDIA's H100 SXM data sheet, dense rates,
700 W). So no implementation can read above 100%.
"""

N = 120            # decision variables (horizon 10 x 12 forces)
M = 200            # constraint rows (horizon 10 x 4 legs x 5)
C_NNZ = 360        # non-zeros of the friction pyramid
F32 = 4            # bytes
# the Newton-Schulz schedule's length when no scaled edge is set
# (ADMMSettings.schulz_iters's default)
SCHULZ_ITERS = 20

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"tf32": 495e12, "fp32": 67e12,
                              "hbm": 3.35e12},
}


def peaks(kind):
    return PEAKS.get(kind)


def k3_work(batch, settings):
    """(product operations, other operations, bytes) of K3 over one call."""
    segments = int(settings.get("segments", 3))
    steps = int(settings.get("schulz_iters", SCHULZ_ITERS))
    mm = ew = nbytes = 0.0
    for seg in range(segments):
        full = steps - 1 if seg == 0 else steps
        mm += full * 4.0 * N ** 3
        ew += 2.0 * N ** 2 * steps
        nbytes += (2 if seg == 0 else 3) * N * N * F32
    return batch * mm, batch * ew, batch * nbytes


def k6_work(batch, settings):
    """(product operations, other operations, bytes) of K6 over one call."""
    segments = int(settings.get("segments", 3))
    iters = int(settings.get("seg_iters", 25))
    mm = segments * iters * 2.0 * N * N
    ew = segments * iters * (4.0 * C_NNZ + 12.0 * M + 6.0 * N)
    nbytes = segments * (N * N + N + 3 * M + 2 * (N + 2 * M)) * F32
    return batch * mm, batch * ew, batch * nbytes


def least_seconds(work, kind):
    """The least time the card ``kind`` could take for ``work``, or None
    for a card the table does not hold."""
    p = peaks(kind)
    if p is None:
        return None
    mm, ew, nbytes = work
    return max(mm / (p["tf32"] / 3.0) + ew / p["fp32"], nbytes / p["hbm"])


def kernel_seconds(events, names):
    """Summed device time of the events whose name holds any of ``names``."""
    return sum(end - start for start, end, name in events
               if any(n in name for n in names)) / 1e6


def roofline(record, work_fn, names):
    """A kernel's share of its roofline over the traced slice, in %."""
    events, calls = record.get("events"), record.get("traced")
    if not events or not calls or "batch" not in record:
        return None
    spent = kernel_seconds(events, names)
    least = least_seconds(work_fn(record["batch"], record["settings"]),
                          record.get("kind"))
    if not spent or least is None:
        return None
    return 100.0 * calls * least / spent
