"""Share of the window's fleet ticks whose GRF solve took a cold route
(the compacted cold sub-batch or the whole batch cold), from the routes
``controller.compute_grf_mpc_batched`` counts into its ``stats``, in %."""


def read(record):
    routes = record.get("routes") or {}
    ticks = sum(routes.values())
    if not ticks:
        return None
    return 100.0 * (routes.get("compact", 0) + routes.get("cold", 0)) / ticks
