"""CUDA graph replays per fleet tick over the window, from the program's
counter ``utils/graphs.replays``: the captured batched tick replays its
"pre" part, a base program and a terminal part, 2-3 a tick by its route.
None where nothing replayed (the CPU composes the tick eagerly)."""


def read(record):
    ticks = record.get("ticks")
    if not ticks or not record.get("replays"):
        return None
    return record["replays"] / ticks
