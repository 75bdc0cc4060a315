"""K3 (ops/schulz_batch)'s share of its roofline in the sweep: the least time an H100
could take for the traced calls' work (counted in ``_sweep_work.py``
from the sweep's shapes and settings) over the kernel's summed device
time in the trace, in %."""

from pathlib import Path

import harness

_work = harness.load_module(Path(__file__).with_name("_sweep_work.py"))
NAMES = ("schulz_batch_kernel", "schulz_tc_cta_kernel", "schulz_tc_cluster_kernel")


def read(record):
    return _work.roofline(record, _work.k3_work, NAMES)
