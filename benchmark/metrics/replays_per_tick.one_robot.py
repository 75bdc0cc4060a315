"""CUDA graph replays per one-robot tick over the window, from the
program's counter ``utils/graphs.replays``: each replay is a host round
trip (the pre step, the route read, the branch, the health re-solve)."""


def read(record):
    ticks = record.get("ticks")
    if not ticks or record.get("replays") is None:
        return None
    return record["replays"] / ticks
