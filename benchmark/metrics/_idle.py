"""The device's idle share of a traced window: the window minus the union
of the device's activity intervals (``busy_s``), over the window."""


def idle_percent(record):
    window, busy = record.get("window_s"), record.get("busy_s")
    if not window or not record.get("events"):
        return None
    return 100.0 * (window - busy) / window
