"""Share of the traced window in which no operation ran on the device
(torch.profiler's device activity), in %."""

from pathlib import Path

import harness

_idle = harness.load_module(Path(__file__).with_name("_idle.py"))


def read(record):
    return _idle.idle_percent(record)
