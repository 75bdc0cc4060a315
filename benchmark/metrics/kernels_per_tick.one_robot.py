"""Kernels the device ran per one-robot tick in the traced slice, from
torch.profiler (copies and fills left out)."""

import harness


def read(record):
    ticks, events = record.get("traced"), record.get("events")
    if not ticks or not events:
        return None
    return sum(1 for e in events if harness.is_kernel(e[2])) / ticks
